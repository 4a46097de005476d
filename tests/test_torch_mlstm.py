"""The port's xLSTM blocks and xlstm-1.3b serving against the JAX package.

Inputs are drawn with numpy from a seed and handed to both packages.
The port runs on the CPU, where ``mlstm_chunk`` takes its plain version;
the reference's Pallas ``mlstm_chunk`` runs in interpret mode and its
oracle is ``_mlstm_chunk_scan``. The served model is reduced xlstm-1.3b
(7 mLSTM and 1 sLSTM layers, d 64), its weights carried over by
``params_from_jax``, with prompts of 16 tokens (one chunk) and of 512
(two 256-token chunks, so the state carries across a chunk) and a
16-token refill.

Tolerances, all f32: the chunk kernel's h, C, n and m rtol 1e-5, atol
1e-5 * max|reference| (sums in another order); the blocks' outputs and
caches rtol 1e-5, atol 1e-5 * max; served tokens exact and, with 16-token
prompts, logits within 1e-4 and "res" sketches and caches rtol 1e-4,
atol 1e-5 * max, as the dense archs' serving test holds them. With
512-token prompts the reduced random model amplifies rounding. Read by
``tools/xlstm_chunk_spread.py`` on a 512-token prefill, relative to the
reference's max: the reference's own logits move by 7.3e-4 when only its
mLSTM chunk changes from 256 to 64 (the same function); the port reads
7.2e-4 on the logits and 2.9e-4 on the caches; a port with q and k
rounded to bf16 reads 0.75 and 0.30. So logits, sketches and caches are
held at rtol 1e-3, atol 1e-3 * max: at the reference's own spread, and
far below what the degraded run reads (it fails every serving case).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.kernels import mlstm_chunk as pallas_mlstm_chunk
from repro.models import ssm as jssm
from repro.models.transformer import abstract_params as jax_abstract_params
from repro.models.transformer import init_cache as jax_init_cache
from repro.models.transformer import init_params as jax_init_params
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_arch, reduced
from repro_torch.interop import params_from_jax, proj_from_jax, tree_from_jax
from repro_torch.kernels import mlstm_chunk as MC
from repro_torch.models import ssm
from repro_torch.models import transformer
from repro_torch.serve import ServeEngine
from repro_torch.serve import engine as engine_mod

TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(got, want, rtol=TOL, atol_rel=TOL):
    want = np.asarray(want)
    atol = atol_rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=atol)


def _gates(rng, B, H, S):
    li = (rng.standard_normal((B, H, S)) * 0.5).astype(np.float32)
    x = rng.standard_normal((B, H, S)) + 2.0
    lf = (-np.log1p(np.exp(-x))).astype(np.float32)     # log_sigmoid
    return li, lf


def _chunk_inputs(seed, B, H, S, Dk, Dv):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((B, H, S, Dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, H, S, Dv)).astype(np.float32)
    return (q, k, v) + _gates(rng, B, H, S)


def _cfg(**cut):
    return (dataclasses.replace(jax_reduced(jax_get_arch("xlstm-1.3b")),
                                **cut),
            dataclasses.replace(reduced(get_arch("xlstm-1.3b")), **cut))


# ---------------------------------------------------------------------------
# the chunk kernel's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,S,Dk,Dv,W", [
    (1, 2, 64, 16, 32, 16),       # test_kernels.py's sweep
    (2, 2, 128, 8, 16, 32),
    (1, 4, 64, 32, 32, 64),
    (2, 3, 96, 8, 12, 32),        # three chunks, odd widths
    (2, 3, 40, 8, 12, 256),       # S < chunk: one chunk of S rows
])
def test_plain_matches_pallas_kernel_and_oracle(B, H, S, Dk, Dv, W):
    args = _chunk_inputs(S + Dk, B, H, S, Dk, Dv)
    h, (C, n, m) = MC.mlstm_chunk_plain(*map(torch.from_numpy, args),
                                        chunk=W)
    ja = [jnp.asarray(a) for a in args]
    zero = lambda *s: jnp.zeros(s, jnp.float32)        # noqa: E731
    want_scan = jssm._mlstm_chunk_scan(
        *ja, zero(B, H, Dk, Dv), zero(B, H, Dk), zero(B, H), W)
    want_pallas = pallas_mlstm_chunk(*ja, chunk=W)
    for want in (want_scan, want_pallas):
        wh, (wC, wn, wm) = want
        for got, ref in ((h, wh), (C, wC), (n, wn), (m, wm)):
            _close(got, ref)


def test_wrapper_takes_the_plain_version_on_cpu_and_counts_nothing():
    args = [torch.from_numpy(a) for a in _chunk_inputs(1, 1, 2, 32, 8, 16)]
    before = MC.mlstm_chunk.launches
    got = MC.mlstm_chunk(*args, chunk=16)
    want = MC.mlstm_chunk_plain(*args, chunk=16)
    assert MC.mlstm_chunk.launches == before
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="not a multiple"):
        MC.mlstm_chunk(*[a[:, :, :24] for a in args], chunk=16)
    with pytest.raises(ValueError, match="do not fit"):
        MC.mlstm_chunk(args[0], args[1][:, :1], *args[2:])


def test_chunked_form_matches_its_sequential_oracle():
    """The port's chunked plain version against its own step-by-step
    recurrence (the reference's ``mlstm_sequential_ref``, ported)."""
    B, H, S, Dk, Dv = 1, 2, 48, 8, 16
    q, k, v, li, lf = map(torch.from_numpy, _chunk_inputs(5, B, H, S, Dk,
                                                          Dv))
    h, state = MC.mlstm_chunk_plain(q, k, v, li, lf, chunk=16)
    f32 = dict(dtype=torch.float32)
    hs, seq = ssm.mlstm_sequential_ref(
        q, k, v, li, lf, torch.zeros((B, H, Dk, Dv), **f32),
        torch.zeros((B, H, Dk), **f32), torch.zeros((B, H), **f32))
    _close(h, _np(hs), rtol=1e-4, atol_rel=1e-4)
    # the two forms carry different stabilisers m: compare C e^m, n e^m
    (C, n, m), (C2, n2, m2) = state, seq
    _close(C * torch.exp(m)[..., None, None],
           _np(C2 * torch.exp(m2)[..., None, None]), rtol=1e-4,
           atol_rel=1e-4)
    _close(n * torch.exp(m)[..., None], _np(n2 * torch.exp(m2)[..., None]),
           rtol=1e-4, atol_rel=1e-4)


# ---------------------------------------------------------------------------
# the blocks' pieces
# ---------------------------------------------------------------------------


def test_mlstm_step_and_conv_match_reference():
    rng = np.random.default_rng(7)
    B, H, Dk, Dv, Fw, Wc = 2, 3, 8, 12, 10, 4
    q, k = (rng.standard_normal((B, H, Dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, H, Dv)).astype(np.float32)
    li, lf = (a[..., 0] for a in _gates(rng, B, H, 1))
    C = rng.standard_normal((B, H, Dk, Dv)).astype(np.float32)
    n = rng.standard_normal((B, H, Dk)).astype(np.float32)
    m = rng.standard_normal((B, H)).astype(np.float32)
    args = (q, k, v, li, lf, C, n, m)
    h, state = ssm.mlstm_step(*map(torch.from_numpy, args))
    wh, wstate = jssm.mlstm_step(*map(jnp.asarray, args))
    for got, want in zip((h,) + state, (wh,) + wstate):
        _close(got, want)

    x = rng.standard_normal((B, 9, Fw)).astype(np.float32)
    w = rng.standard_normal((Wc, Fw)).astype(np.float32)
    bias = rng.standard_normal((Fw,)).astype(np.float32)
    conv_state = rng.standard_normal((B, Wc - 1, Fw)).astype(np.float32)
    _close(ssm.causal_conv(*map(torch.from_numpy, (x, w, bias))),
           jssm.causal_conv(*map(jnp.asarray, (x, w, bias))))
    y, st = ssm.causal_conv_step(*map(torch.from_numpy,
                                      (x[:, 0], conv_state, w, bias)))
    wy, wst = jssm.causal_conv_step(*map(jnp.asarray,
                                         (x[:, 0], conv_state, w, bias)))
    _close(y, wy)
    _close(st, wst)


def _jit(fn, **static):
    """The reference block compiled once (its eager op-by-op dispatch is
    slower than a compile)."""
    return jax.jit(functools.partial(fn, **static))


def _block_params(init, cfg_j, seed):
    jp = init(jax.random.PRNGKey(seed), cfg_j, jnp.float32)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


@pytest.mark.parametrize("slstm_chunk", [0, 4])
def test_slstm_apply_matches_reference(slstm_chunk):
    """The port's one loop over time against both reference scans."""
    jcfg, cfg = _cfg()
    jcfg = dataclasses.replace(jcfg, slstm_chunk=slstm_chunk)
    jp, p = _block_params(jssm.slstm_init, jcfg, 11)
    x = np.random.default_rng(11).standard_normal((2, 16, 64)).astype(
        np.float32)
    y, cache = ssm.slstm_apply(p, torch.from_numpy(x), cfg=cfg,
                               mode="prefill")
    wy, wcache = _jit(jssm.slstm_apply, cfg=jcfg, mode="prefill")(
        jp, jnp.asarray(x))
    _close(y, wy)
    for name in wcache:
        _close(cache[name], wcache[name])
    x1 = x[:, :1] * 0.5
    y1, c1 = ssm.slstm_apply(p, torch.from_numpy(x1), cfg=cfg,
                             mode="decode", cache=cache)
    wy1, wc1 = _jit(jssm.slstm_apply, cfg=jcfg, mode="decode")(
        jp, jnp.asarray(x1), cache=wcache)
    _close(y1, wy1)
    for name in wc1:
        _close(c1[name], wc1[name])


def test_mlstm_apply_matches_reference():
    """Prefill at chunk 16 over S 64 (four chunks), eval, and one decode
    step from the prefill's cache."""
    jcfg, cfg = _cfg()
    jp, p = _block_params(jssm.mlstm_init, jcfg, 12)
    x = np.random.default_rng(12).standard_normal((2, 64, 64)).astype(
        np.float32)
    y, cache = ssm.mlstm_apply(p, torch.from_numpy(x), cfg=cfg,
                               mode="prefill", chunk=16)
    wy, wcache = _jit(jssm.mlstm_apply, cfg=jcfg, mode="prefill", chunk=16)(
        jp, jnp.asarray(x))
    _close(y, wy)
    for name in ("C", "m_n", "m_m", "conv"):
        _close(cache[name], wcache[name])
    ye, ce = ssm.mlstm_apply(p, torch.from_numpy(x), cfg=cfg, mode="eval",
                             chunk=16)
    assert ce is None
    _close(ye, wy)
    x1 = x[:, :1] * 0.5
    y1, c1 = ssm.mlstm_apply(p, torch.from_numpy(x1), cfg=cfg,
                             mode="decode", cache=cache)
    wy1, wc1 = _jit(jssm.mlstm_apply, cfg=jcfg, mode="decode")(
        jp, jnp.asarray(x1), cache=wcache)
    _close(y1, wy1)
    for name in ("C", "m_n", "m_m", "conv"):
        _close(c1[name], wc1[name])


# ---------------------------------------------------------------------------
# the model and its configuration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cut", [False, True])
def test_param_count_and_layout_match_reference(cut):
    """num_params against the reference's abstract parameters (2.12 B at
    full width); the reduced model's leaves, as params_from_jax carries
    them, against the port's own init, layer by layer."""
    jcfg, cfg = _cfg() if cut else (jax_get_arch("xlstm-1.3b"),
                                    get_arch("xlstm-1.3b"))
    leaves = jax.tree.leaves(jax_abstract_params(jcfg))
    assert transformer.num_params(cfg) == sum(int(np.prod(a.shape))
                                              for a in leaves)
    if not cut:
        assert transformer.num_params(cfg) == 2_120_862_032
        return
    ported = params_from_jax(jax.tree.map(
        np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg)))
    own = transformer.init_params(torch.Generator().manual_seed(0), cfg)

    def shapes(tree):
        return jax.tree.map(lambda t: tuple(t.shape), tree)

    assert shapes(ported) == shapes(own)
    assert [sorted(layer) for layer in own["layers"]] == \
        [["mix", "norm1"]] * cfg.num_layers


def test_init_cache_matches_reference_shapes():
    jcfg, cfg = _cfg()
    jc = jax_init_cache(jcfg, 3, 32)
    want = [jax.tree.map(lambda a, g=g: (tuple(a.shape[1:]), str(a.dtype)),
                         jc["groups"][i])
            for g in range(jcfg.num_groups) for i in range(len(jcfg.pattern))]
    got = transformer.init_cache(cfg, 3, 32, "cpu")
    assert [{k: (tuple(t.shape), str(t.dtype).split(".")[-1])
             for k, t in layer.items()} for layer in got] == want


def test_decode_matches_parallel():
    """One-step recurrence == the eval forward at the last position (the
    port's own check, as test_ssm_rglru.py's for the reference)."""
    _, cfg = _cfg()
    params = transformer.init_params(torch.Generator().manual_seed(4), cfg)
    B, S = 2, 16
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S)))
    ref = transformer.forward(params, tokens, cfg=cfg, mode="eval")["logits"]
    pf = transformer.forward(params, tokens[:, :S - 1], cfg=cfg,
                             mode="prefill", seq_len_ctx=S)
    dec = transformer.forward(params, tokens[:, S - 1:], cfg=cfg,
                              mode="decode",
                              positions=torch.full((B,), S - 1),
                              cache=pf["cache"], seq_len_ctx=S)
    np.testing.assert_allclose(_np(dec["logits"][:, 0]), _np(ref[:, S - 1]),
                               atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# serving, against the reference engine
# ---------------------------------------------------------------------------

BATCH, REFILL, MAX_CONTEXT, DECODE_STEPS = 2, 16, 530, 3


def _drive(eng, prompts, refill_prompt):
    toks = [_np(eng.start(prompts))]
    logits = []
    for _ in range(DECODE_STEPS):
        toks.append(_np(eng.decode_step()))
        logits.append(_np(eng.last_logits))
    eng.refill(1, refill_prompt)
    toks.append(_np(eng._slots["tok"]))
    toks.append(_np(eng.decode_step()))
    logits.append(_np(eng.last_logits))
    return np.stack(toks), np.stack(logits)


def _serve_both(prompt_len):
    jcfg, cfg = _cfg()
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (BATCH, prompt_len))
    refill_prompt = rng.integers(0, cfg.vocab_size, (REFILL,))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    jeng = JaxServeEngine(cfg=jcfg, params=jparams, max_context=MAX_CONTEXT,
                          monitor=True)
    j_toks, j_logits = _drive(jeng, jnp.asarray(prompts, jnp.int32),
                              jnp.asarray(refill_prompt, jnp.int32))
    tree0 = jax.tree.map(np.asarray, jeng._init_monitor(BATCH).tree)
    proj = {n: proj_from_jax(jax.tree.map(np.asarray, jeng._proj_for(n)))
            for n in (BATCH * prompt_len, REFILL)}
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    out = dict(jeng=jeng, j_toks=j_toks, j_logits=j_logits)
    for monitor in (True, False):
        eng = ServeEngine(cfg=cfg, params=params, max_context=MAX_CONTEXT,
                          monitor=monitor, device="cpu", projections=proj,
                          initial_tree=tree_from_jax(tree0))
        toks, logits = _drive(eng, torch.from_numpy(prompts),
                              torch.from_numpy(refill_prompt))
        out[monitor] = dict(eng=eng, toks=toks, logits=logits)
    return out


@pytest.fixture(scope="module", params=[16, 512])
def served(request):
    out = _serve_both(request.param)
    out["tol"] = (dict(rtol=1e-4, atol_rel=1e-5) if request.param == 16
                  else dict(rtol=1e-3, atol_rel=1e-3))
    return out


def test_served_tokens_and_logits_match_reference(served):
    np.testing.assert_array_equal(served[True]["toks"], served["j_toks"])
    np.testing.assert_array_equal(served[False]["toks"], served["j_toks"])
    if served["tol"]["rtol"] == 1e-4:
        np.testing.assert_allclose(served[True]["logits"],
                                   served["j_logits"], rtol=1e-4, atol=1e-4)
    else:
        _close(served[True]["logits"], served["j_logits"], **served["tol"])


def test_served_sketches_and_caches_match_reference(served):
    jeng, eng = served["jeng"], served[True]["eng"]
    jtree, tree = jeng._slots["mon"].tree, eng._slots["mon"].tree
    assert tree.step == int(jtree.step) == DECODE_STEPS + 3
    for f in ("x", "y", "z"):
        _close(getattr(tree.nodes["res"], f), getattr(jtree.nodes["res"], f),
               **served["tol"])
    # every recurrent cache entry of every slot, the refilled one too
    jc = jeng._slots["cache"]
    P = len(jeng.cfg.pattern)
    for layer, one in enumerate(eng._slots["cache"]):
        want = jc["groups"][layer % P]
        for name, t in one.items():
            _close(t, np.asarray(want[name])[layer // P], **served["tol"])


def test_prompt_length_is_checked_before_any_work(monkeypatch):
    _, cfg = _cfg()
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)

    def no_work(*a, **k):
        raise AssertionError("the engine ran a forward")

    eng = ServeEngine(cfg=cfg, params=params, max_context=1024,
                      device="cpu")
    eng.start(torch.zeros((1, 16), dtype=torch.long))
    monkeypatch.setattr(engine_mod, "forward", no_work)
    for bad in (300, 257):
        with pytest.raises(ValueError, match="not a multiple"):
            eng.start(torch.zeros((1, bad), dtype=torch.long))
        with pytest.raises(ValueError, match="not a multiple"):
            eng.refill(0, torch.zeros((bad,), dtype=torch.long))


@pytest.mark.parametrize("arch,S,ok", [
    ("xlstm-1.3b", 16, True), ("xlstm-1.3b", 256, True),
    ("xlstm-1.3b", 512, True), ("xlstm-1.3b", 300, False),
    ("tinyllama-1.1b", 300, True),      # attention takes any length
])
def test_check_seq_len_goes_by_block_kind(arch, S, ok):
    cfg = reduced(get_arch(arch))
    if ok:
        transformer.check_seq_len(cfg, S)
    else:
        with pytest.raises(ValueError, match="not a multiple"):
            transformer.check_seq_len(cfg, S)
