"""The port's flash attention against the JAX package.

Inputs are drawn with numpy from a seed and given to both packages. The
port runs on the CPU, where ``flash_attention`` takes its plain versions
(``flash_attention_plain``, ``flash_attention_bwd_plain``); the JAX side
is the Pallas kernel in interpret mode (``q_blk = kv_blk = 32``, so S a
multiple of 32), its oracle ``kernels.ref.flash_attention_ref`` and, for
gradients, ``jax.vjp`` of that oracle.

Tolerances: f32 2e-5 (atol and rtol) against the kernel and the oracle,
as ``tests/test_kernels.py`` holds the Pallas kernel; bf16 2e-2, the
same; gradients in f32 rtol 1e-5, atol 1e-5 * max|reference| (sums in
another order). The model's attention in train mode against the JAX
``attn_apply`` in f32 at 1e-5. In bf16 the plain versions keep P in
f32, as the TPU kernel does, where the JAX model's chunked scan rounds P
to bf16: that gap is measured and held within 2e-2. (The card's bf16
kernels round P as the scan does; tests/test_torch_flash_attention_cuda.py
holds them against the plain versions.)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.kernels import flash_attention as jax_flash_attention
from repro.kernels.ref import flash_attention_ref
from repro.models.attention import attn_apply as jax_attn_apply
from repro.models.attention import chunked_causal_attention
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import flash_attention as FA
from repro_torch.models.attention import attn_apply

# tests/test_kernels.py::test_flash_attention_sweep's cases
SWEEP = [(1, 2, 1, 64, 16, None), (2, 4, 2, 128, 32, None),
         (1, 4, 4, 128, 16, 32), (2, 8, 2, 64, 64, 16)]
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(seed, B, Hq, Hkv, S, D, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, h, S, D)).astype(np.float32)
            for h in (Hq, Hkv, Hkv, Hq)]
    torch_ts = [torch.from_numpy(a).to(dtype) for a in arrs]
    jax_ts = [jnp.asarray(a, JNP[dtype]) for a in arrs]
    return torch_ts, jax_ts


def _close(got, want, tol, rel_atol=False):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor)
                     else jnp.asarray(got, jnp.float32))
    want = np.asarray(want.float() if isinstance(want, torch.Tensor)
                      else jnp.asarray(want, jnp.float32))
    atol = tol * np.abs(want).max() if rel_atol else tol
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


@pytest.mark.parametrize("B,Hq,Hkv,S,D,window", SWEEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_pallas_kernel_and_oracle(B, Hq, Hkv, S, D, window,
                                                dtype, monkeypatch):
    (q, k, v, _), (jq, jk, jv, _) = _inputs(S + D, B, Hq, Hkv, S, D, dtype)
    monkeypatch.setattr(FA, "PLAIN_CHUNK", 48)
    o, lse = FA.flash_attention_plain(q, k, v, window=window)
    assert o.dtype == dtype and lse.dtype == torch.float32
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    _close(o, jax_flash_attention(jq, jk, jv, causal=True, window=window,
                                  q_blk=32, kv_blk=32), tol)
    _close(o, flash_attention_ref(jq, jk, jv, causal=True, window=window),
           tol)
    # lse is the log-partition of the oracle's scores
    s = jnp.einsum("bhgqd,bhkd->bhgqk",
                   jnp.asarray(q.float().numpy()).reshape(B, Hkv, Hq // Hkv,
                                                          S, D),
                   jnp.asarray(k.float().numpy())) * D ** -0.5
    rel = jnp.arange(S)[:, None] - jnp.arange(S)[None, :]
    live = (rel >= 0) & (rel < (window or S + 1))
    want = jax.nn.logsumexp(jnp.where(live, s, -1e30), axis=-1)
    _close(lse, want.reshape(B, Hq, S), 2e-5)


@pytest.mark.parametrize("S,window", [(37, None), (5, None), (70, 16),
                                      (1, None), (50, 20)])
def test_ragged_and_short_sequences_match_oracle(S, window, monkeypatch):
    (q, k, v, _), (jq, jk, jv, _) = _inputs(S, 2, 4, 2, S, 16)
    # a chunk that does not divide S: the last step is ragged too
    monkeypatch.setattr(FA, "PLAIN_CHUNK", 24)
    o, _ = FA.flash_attention_plain(q, k, v, window=window)
    _close(o, flash_attention_ref(jq, jk, jv, causal=True, window=window),
           2e-5)


@pytest.mark.parametrize("Hq,Hkv,S,window", [(4, 4, 48, None), (4, 2, 80, 24),
                                             (8, 2, 70, None), (4, 1, 33, 8)])
def test_gradients_match_jax_grad_of_oracle(Hq, Hkv, S, window):
    (q, k, v, do), (jq, jk, jv, jdo) = _inputs(Hq * S, 2, Hq, Hkv, S, 16)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = FA.flash_attention(*leaves, window=window)
    got = torch.autograd.grad(o, leaves, do)
    want_o, vjp = jax.vjp(lambda a, b, c: flash_attention_ref(
        a, b, c, causal=True, window=window), jq, jk, jv)
    _close(o.detach(), want_o, 1e-5, rel_atol=True)
    for g, w in zip(got, vjp(jdo)):
        _close(g, w, 1e-5, rel_atol=True)
    # the CPU wrapper's backward is the plain version's
    _, lse = FA.flash_attention_plain(q, k, v, window=window)
    for g, w in zip(got, FA.flash_attention_bwd(q, k, v, o.detach(), lse, do,
                                                window=window)):
        assert torch.equal(g, w)


def _attn_layer(seed, S):
    """Reduced gemma3 (window 32) in f32: a local layer's params, an
    input and a cotangent, as numpy."""
    tcfg = reduced(get_arch("gemma3-27b"))
    jcfg = jax_reduced(jax_get_arch("gemma3-27b"))
    rng = np.random.default_rng(seed)
    d, H, KV, D = tcfg.d_model, tcfg.num_heads, tcfg.num_kv_heads, 16
    shapes = {"wq": (d, H, D), "wk": (d, KV, D), "wv": (d, KV, D),
              "wo": (H, D, d)}
    p = {n: (rng.standard_normal(s) * 0.3).astype(np.float32)
         for n, s in shapes.items()}
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    cot = rng.standard_normal((2, S, d)).astype(np.float32)
    return tcfg, jcfg, p, x, cot


@pytest.mark.parametrize("layer_type", ["local", "global"])
def test_attn_apply_train_mode_matches_reference(layer_type):
    S = 80
    tcfg, jcfg, p, x, cot = _attn_layer(3, S)
    assert S > tcfg.window_size
    pos = np.broadcast_to(np.arange(S), (2, S))

    def jax_loss(jp, jx):
        y, _ = jax_attn_apply(jp, jx, cfg=jcfg, layer_type=layer_type,
                              positions=jnp.asarray(pos), mode="train",
                              seq_len_ctx=S)
        return jnp.sum(y * cot), y

    (_, jy), (jgp, jgx) = jax.value_and_grad(jax_loss, argnums=(0, 1),
                                             has_aux=True)(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x))
    tp = {n: torch.from_numpy(a).requires_grad_(True) for n, a in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, _ = attn_apply(tp, tx, cfg=tcfg, layer_type=layer_type,
                      positions=torch.from_numpy(pos.copy()), mode="train",
                      seq_len_ctx=S)
    (y * torch.from_numpy(cot)).sum().backward()
    _close(y.detach(), jy, 1e-5, rel_atol=True)
    _close(tx.grad, jgx, 1e-5, rel_atol=True)
    for n in p:
        _close(tp[n].grad, jgp[n], 1e-5, rel_atol=True)


def test_bf16_gap_to_the_reference_models_scan():
    """The port keeps P in f32; the JAX model's scan rounds P (and the
    scaled q) to bf16 before its products. Measured: the largest gap over
    these inputs, relative to max|o|."""
    B, S, KV, G, D = 2, 256, 2, 4, 64
    (q, k, v, _), _ = _inputs(11, B, KV * G, KV, S, D, torch.bfloat16)
    o, _ = FA.flash_attention_plain(q, k, v, window=None)
    qg = jnp.asarray(q.float().numpy(), jnp.bfloat16).reshape(
        B, KV, G, S, D).transpose(0, 3, 1, 2, 4)
    kk, vv = (jnp.asarray(t.float().numpy(), jnp.bfloat16).transpose(
        0, 2, 1, 3) for t in (k, v))
    want = chunked_causal_attention(qg, kk, vv, window=None, chunk=64)
    want = want.transpose(0, 2, 3, 1, 4).reshape(B, KV * G, S, D)
    got = o.float().numpy()
    want = np.asarray(want, np.float32)
    gap = np.abs(got - want).max() / np.abs(want).max()
    print(f"bf16 gap, f32 P against the scan's bf16 P: {gap:.3e} of max|o|")
    assert 0 < gap
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_bf16_gaps_hold_each_row_to_its_own_scale():
    """The card's bf16 check (``bf16_gaps``) scales each row's allowance
    by that row's largest plain value: 6% off in the late rows of a long
    sequence, whose values are a small share of the first rows', fails
    it, where an allowance scaled by the tensor's largest would pass;
    the plain output rounded to bf16 passes; a row of rounding noise
    (dq's first row is zero in exact arithmetic) answers to ROW_FLOOR of
    the tensor's largest, not to its own."""
    (q, k, v, _), _ = _inputs(13, 1, 2, 1, 512, 64)
    o, _ = FA.flash_attention_plain(q, k, v)
    assert FA.bf16_gaps(o.bfloat16(), o)[1] <= 1
    late = o.clone()
    late[:, :, 256:] *= 1.06
    assert FA.bf16_gaps(late, o)[1] > 1
    diff = (late - o).abs()
    assert (diff <= FA.BF16_TOL * (o.abs().max() + o.abs())).all()
    noisy, want = o.clone(), o.clone()
    want[:, :, 0] = 1e-9
    noisy[:, :, 0] = 2e-9
    assert FA.bf16_gaps(noisy, want)[1] <= 1


def test_autograd_function_saves_nothing_of_size_s_by_s():
    B, Hq, Hkv, S, D = 1, 4, 2, 96, 16
    (q, k, v, _), _ = _inputs(5, B, Hq, Hkv, S, D)

    def saved_shapes(fn):
        shapes = []
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: shapes.append(tuple(t.shape)) or t.detach(),
                lambda t: t):
            fn(*leaves)
        return shapes

    got = saved_shapes(lambda a, b, c: FA.flash_attention(a, b, c, window=40))
    assert sorted(got) == sorted([(B, Hq, S, D), (B, Hkv, S, D),
                                  (B, Hkv, S, D), (B, Hq, S, D), (B, Hq, S)])
    # the plain forward under autograd keeps (.., S, S) score tensors
    plain = saved_shapes(lambda a, b, c: FA.flash_attention_plain(
        a, b, c, window=40))
    assert any(s[-2:] == (S, S) for s in plain)


def test_cpu_wrappers_take_the_plain_versions_and_count_no_launch():
    (q, k, v, do), _ = _inputs(7, 1, 2, 1, 20, 64)
    before = (FA.flash_attention_fwd.launches, FA.flash_attention_bwd.launches)
    o, lse = FA.flash_attention_fwd(q, k, v, window=8)
    want_o, want_lse = FA.flash_attention_plain(q, k, v, window=8)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, window=8)
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, window=8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (FA.flash_attention_fwd.launches,
            FA.flash_attention_bwd.launches) == before


@pytest.mark.parametrize("B,Hkv,S,G,want", [
    (2, 1, 512, 48, 17),     # granite-34b's MQA: 16 blocks unsplit
    (8, 4, 128, 8, 5),       # tinyllama-1.1b's train step
    (4, 4, 2048, 8, 1),      # tinyllama-1.1b at its context: 512 blocks
    (1, 1, 37, 2, 2)])       # never more slices than query heads
def test_dkdv_pass_splits_groups_until_each_sm_has_two_blocks(B, Hkv, S, G,
                                                              want):
    assert FA.dkdv_splits(B, Hkv, S, G, sms=132) == want


def test_wrappers_refuse_what_the_kernels_do_not_take():
    (q, k, v, _), _ = _inputs(9, 1, 4, 2, 16, 16)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        FA.flash_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="does not fit"):
        FA.flash_attention_fwd(q, k[:, :, :8], v)
    with pytest.raises(ValueError, match="does not fit"):
        FA.flash_attention_fwd(q[:, :3], k, v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FA.flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="v must be"):
        FA.flash_attention_fwd(q, k, v.bfloat16())
    with pytest.raises(ValueError, match="window"):
        FA.flash_attention_fwd(q, k, v, window=0)
    with pytest.raises(ValueError, match="head_dim 32 has no"):
        FA._check_cuda(32, q=q)
    with pytest.raises(ValueError, match="stride 1 along D"):
        FA._check_cuda(16, q=q.transpose(2, 3))
    # the bf16 (tensor-core) kernels: no head_dim 16, and tensor maps
    # step in 16-byte units
    with pytest.raises(ValueError, match="head_dim 16 has no"):
        FA._check_cuda(16, q=q.bfloat16())
    rows_68 = torch.zeros((1, 4, 16, 68), dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte units"):
        FA._check_cuda(64, q=rows_68)
    FA._check_cuda(64, q=torch.zeros((1, 4, 16, 72),
                                     dtype=torch.bfloat16)[..., :64])

