"""The port's RG-LRU block and recurrentgemma-2b's configuration against
the JAX package, on the CPU.

The scan: ``rglru_scan`` (a doubling scan, its gradient the same scan
reversed) against the reference's ``lax.associative_scan`` and
``jax.vjp`` of it at a ragged S 37, log a from the model's own gates.
The block: ``rglru_apply`` in eval, prefill (S 37, and S 2 below the
conv width, whose conv state is left-padded) and decode from the
prefill's cache, and in train mode with the carry, on the reduced
width (d 64) from the reference's ``rglru_init``. The reference's blocks
run jitted, compiled once a module. Tolerance: rtol 1e-5, atol 1e-5 *
max|reference| (f32 on both sides, the scan's sums in another order).
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
from repro.models import rglru as jrglru
from repro.models.transformer import abstract_params as jax_abstract_params
from repro.models.transformer import init_cache as jax_init_cache
from repro.models.transformer import init_params as jax_init_params
from repro.models.transformer import sketch_groups as jax_sketch_groups
from repro_torch.configs import get_arch, reduced
from repro_torch.interop import params_from_jax
from repro_torch.models import rglru, transformer

TOL = 1e-5
ARCH = "recurrentgemma-2b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the module's ops are small, and the other
    xdist workers share the cores. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    atol = tol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=atol)


def _cfgs():
    return jax_reduced(jax_get_arch(ARCH)), reduced(get_arch(ARCH))


@pytest.fixture(scope="module")
def block():
    """The reference block's weights (reduced width) and the port's copy."""
    jcfg, cfg = _cfgs()
    jp = jrglru.rglru_init(jax.random.PRNGKey(5), jcfg, jnp.float32)
    return jcfg, cfg, jp, {k: torch.from_numpy(np.array(v))
                           for k, v in jp.items()}


def _scan_inputs(jp, B=2, S=37, seed=3):
    """log a and b of the model's own scale: gates from a random conv
    output through the reference's ``_gates``."""
    lru = jp["a_param"].shape[0]
    xi = np.random.default_rng(seed).standard_normal((B, S, lru)).astype(
        np.float32)
    la, b = jax.jit(jrglru._gates)(jp, jnp.asarray(xi))
    return np.array(la), np.array(b)


def test_scan_matches_associative_scan_and_its_vjp(block):
    _, _, jp, _ = block
    la, b = _scan_inputs(jp)
    dh = np.random.default_rng(4).standard_normal(b.shape).astype(np.float32)
    # jitted: the eager associative scan and its vjp take 10 s here
    want, (wla, wb) = jax.jit(
        lambda la, b, dh: (lambda h, vjp: (h, vjp(dh)))(
            *jax.vjp(jrglru.rglru_scan, la, b)))(la, b, dh)
    tla = torch.from_numpy(la).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    h = rglru.rglru_scan(tla, tb)
    _close(h, want)
    h.backward(torch.from_numpy(dh))
    _close(tla.grad, wla)
    _close(tb.grad, wb)


@pytest.mark.parametrize("S", [1, 2, 5, 8])
def test_scan_matches_sequential_recurrence(S):
    """Short and power-of-two lengths, where the doubling scan's last
    pass is its first or reaches S exactly, against the one-step loop."""
    rng = np.random.default_rng(S)
    la = -np.abs(rng.standard_normal((1, S, 3))).astype(np.float32)
    b = rng.standard_normal((1, S, 3)).astype(np.float32)
    h, want = np.zeros((1, 3), np.float32), []
    for t in range(S):
        h = np.exp(la[:, t]) * h + b[:, t]
        want.append(h)
    _close(rglru.rglru_scan(torch.from_numpy(la), torch.from_numpy(b)),
           np.stack(want, axis=1))


def _jit(**static):
    return jax.jit(functools.partial(jrglru.rglru_apply, **static))


@pytest.mark.parametrize("S", [37, 2])
def test_rglru_apply_prefill_eval_and_decode_match_reference(block, S):
    jcfg, cfg, jp, p = block
    x = np.random.default_rng(S).standard_normal((2, S, 64)).astype(
        np.float32)
    y, cache = rglru.rglru_apply(p, torch.from_numpy(x), cfg=cfg,
                                 mode="prefill")
    wy, wcache = _jit(cfg=jcfg, mode="prefill")(jp, jnp.asarray(x))
    _close(y, wy)
    for name in ("r_h", "conv"):
        _close(cache[name], wcache[name])
    ye, ce = rglru.rglru_apply(p, torch.from_numpy(x), cfg=cfg, mode="eval")
    assert ce is None
    _close(ye, wy)
    x1 = x[:, :1] * 0.5
    y1, c1 = rglru.rglru_apply(p, torch.from_numpy(x1), cfg=cfg,
                               mode="decode", cache=cache)
    wy1, wc1 = _jit(cfg=jcfg, mode="decode")(jp, jnp.asarray(x1),
                                             cache=wcache)
    _close(y1, wy1)
    for name in ("r_h", "conv"):
        _close(c1[name], wc1[name])


def test_rglru_apply_train_carry_and_gradient_match_reference(block):
    """The train forward with the carry h_S, and the gradient of a
    weighted sum of y through the block, against jax.grad."""
    jcfg, cfg, jp, p = block
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 37, 64)).astype(np.float32)
    wgt = rng.standard_normal((2, 37, 64)).astype(np.float32)
    y, cache, carry = rglru.rglru_apply(p, torch.from_numpy(x), cfg=cfg,
                                        mode="train", return_carry=True)
    wy, _, wcarry = _jit(cfg=jcfg, mode="train", return_carry=True)(
        jp, jnp.asarray(x))
    assert cache is None and not carry.requires_grad
    _close(y, wy)
    _close(carry, wcarry)

    def loss(params, xs):
        return jnp.sum(jrglru.rglru_apply(params, xs, cfg=jcfg,
                                          mode="train")[0] * wgt)

    wg, wgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    (rglru.rglru_apply(tp, tx, cfg=cfg, mode="train")[0]
     * torch.from_numpy(wgt)).sum().backward()
    _close(tx.grad, wgx)
    for k in p:
        _close(tp[k].grad, wg[k])


def test_init_cache_matches_reference_shapes():
    jcfg, cfg = _cfgs()
    jc = jax_init_cache(jcfg, 3, 32)
    want = [jax.tree.map(lambda a, g=g: (tuple(a.shape[1:]), str(a.dtype)),
                         jc["groups"][i])
            for g in range(jcfg.num_groups) for i in range(len(jcfg.pattern))]
    got = transformer.init_cache(cfg, 3, 32, "cpu")
    assert [{k: (tuple(t.shape), str(t.dtype).split(".")[-1])
             for k, t in layer.items()} for layer in got] == want


# ---------------------------------------------------------------------------
# the configuration and the parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cut", [False, True])
def test_config_matches_reference_field_for_field(cut):
    """Every field the port's ArchConfig has, lru_width included (the
    reduced config's 0: the RG-LRU width follows the reduced d_model)."""
    jcfg = jax_get_arch(ARCH)
    cfg = get_arch(ARCH)
    if cut:
        jcfg, cfg = jax_reduced(jcfg), reduced(cfg)
    dtypes = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    for f in dataclasses.fields(cfg):
        got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
        if isinstance(got, torch.dtype):
            got, want = dtypes[got], jnp.dtype(want).name
        assert got == want, f.name
    assert cfg.lru_width == (0 if cut else 2560)
    assert transformer.sketch_groups(cfg) == jax_sketch_groups(jcfg)


@pytest.mark.parametrize("cut", [False, True])
def test_param_count_and_layout_match_reference(cut):
    """num_params and num_reference_leaves against the reference's
    abstract parameters (2.89 B at full width); the reduced model's
    leaves, as params_from_jax carries them, against the port's own
    init, and the RG-LRU leaves carried across unchanged."""
    jcfg, cfg = _cfgs() if cut else (jax_get_arch(ARCH), get_arch(ARCH))
    leaves = jax.tree.leaves(jax_abstract_params(jcfg))
    assert transformer.num_params(cfg) == sum(int(np.prod(a.shape))
                                              for a in leaves)
    assert transformer.num_reference_leaves(cfg) == len(leaves)
    if not cut:
        assert transformer.num_params(cfg) == 2_894_481_920
        return
    jparams = jax.tree.map(np.asarray,
                           jax_init_params(jax.random.PRNGKey(0), jcfg))
    ported = params_from_jax(jparams)
    own = transformer.init_params(torch.Generator().manual_seed(0), cfg)

    def shapes(tree):
        return jax.tree.map(lambda t: (tuple(t.shape), t.dtype), tree)

    assert shapes(ported) == shapes(own)
    assert len(transformer.reference_leaves(own, cfg)) == len(leaves)
    for layer in (0, 1):
        for name, want in jparams["groups"][layer]["mix"].items():
            np.testing.assert_array_equal(
                _np(ported["layers"][layer]["mix"][name]), want[0])
