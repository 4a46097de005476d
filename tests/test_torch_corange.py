"""The port's corange (Tropp) variant and its faithful pseudo-inverse
against the JAX reference, on the CPU at small sizes.

Inputs are drawn once with numpy (or made on the JAX side and carried
over with ``repro_torch.interop``) and fed to both packages.
Tolerances, f32 on both sides with sums in other orders:
  * the EMA updates and the pinv: rtol 1e-5, atol 1e-6 * max|reference|;
  * reconstructions: rtol 1e-5, atol 1e-5 * max|reference| (a QR and two
    pinvs amplify rounding by the sketches' condition numbers);
  * the corange trajectory: losses rtol 1e-5 over 20 steps (the paper
    kinds' tolerance, test_torch_paper_trainer.py), sketches 1e-4 *
    max|reference|;
  * gradients of ``lowrank_grad_matmul``: rtol 1e-5, atol 1e-6 * max.
The psparse-corange matrices are equal bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper import MLPConfig as JaxMLPConfig
from repro.core import corange as JC
from repro.core.monitor import tree_metrics as jax_tree_metrics
from repro.core.reconstruct import reconstruct as jax_reconstruct
from repro.core.sketch import SketchConfig as JaxSketchConfig
from repro.data.synthetic import class_prototypes, classification_batch
from repro.models.mlp import mlp_init as jax_mlp_init
from repro.sketches.psparse import \
    make_psparse_corange_projections as jax_psparse_corange
from repro.sketches.tree import tree_memory_bytes as jax_tree_bytes
from repro.train import paper_trainer as JT
from repro_torch.configs.paper import MLPConfig
from repro_torch.core import corange as PC
from repro_torch.core.monitor import tree_metrics
from repro_torch.core.reconstruct import pinv, reconstruct
from repro_torch.core.sketch import SketchConfig
from repro_torch.interop import (
    mlp_params_from_jax, proj_from_jax, tree_from_jax,
)
from repro_torch.sketches.tree import refresh_tree, tree_memory_bytes, tree_to
from repro_torch.train import paper_trainer as PT

CFG_KW = dict(name="t", d_in=32, d_hidden=48, d_out=4, num_hidden_layers=3,
              activation="tanh", batch_size=32, learning_rate=2e-3)
SCFG_KW = dict(rank=3, max_rank=6, beta=0.9, batch_size=32,
               recon_mode="fast")
K_MAX, STEPS = 13, 20


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, rtol, atol_rel):
    want = np.asarray(want)
    np.testing.assert_allclose(
        _np(got), want, rtol=rtol,
        atol=atol_rel * max(float(np.abs(want).max()), 1e-30))


def _proj(d, nb, k_max, seed):
    """Gaussian corange projections for both packages."""
    rng = np.random.default_rng(seed)
    s = 2 * k_max + 1
    mats = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((k_max, d), (nb, k_max), (s, d), (nb, s))]
    return (JC.CorangeProjections(*map(jnp.asarray, mats)),
            PC.CorangeProjections(*map(torch.from_numpy, mats)))


def _low_rank_batches(n, nb, d, r, seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((d, r)).astype(np.float32)
    return [(rng.standard_normal((nb, r)).astype(np.float32) @ u.T)
            for _ in range(n)]


def _updated(batches, jproj, proj, d, nb, k_active, beta=0.9):
    s = 2 * K_MAX + 1
    jt = (jnp.zeros((K_MAX, nb)), jnp.zeros((d, K_MAX)), jnp.zeros((s, s)))
    pt = (torch.zeros((K_MAX, nb)), torch.zeros((d, K_MAX)),
          torch.zeros((s, s)))
    for a in batches:
        jt = JC.corange_update(*jt, jnp.asarray(a), jproj, beta,
                               jnp.asarray(k_active))
        pt = PC.corange_update(*pt, torch.from_numpy(a), proj, beta,
                               torch.tensor(k_active))
    return jt, pt


# -- the faithful pinv (C5) ---------------------------------------------------


def test_pinv_matches_jnp_on_finite_batches():
    rng = np.random.default_rng(0)
    for shape in ((6, 3), (3, 6), (4, 27, 13)):
        a = rng.standard_normal(shape).astype(np.float32)
        a[..., :, -1] = a[..., :, 0]          # rank deficient: the cut-off
        _close(pinv(torch.from_numpy(a)), jnp.linalg.pinv(a), 1e-5, 1e-6)


def test_pinv_of_a_nonfinite_matrix_is_nan_and_does_not_raise():
    """One NaN: all NaN, as jnp.linalg.pinv gives. One inf: LAPACK gives
    the reference a mix of NaN and 0 here (and at other places no result:
    ROADMAP §C, C5), the port all NaN. In a batch, only the matrix that
    holds the entry."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((6, 3)).astype(np.float32)
    nan, inf = a.copy(), a.copy()
    nan[2, 1], inf[2, 1] = np.nan, np.inf
    np.testing.assert_array_equal(np.isnan(_np(pinv(torch.from_numpy(nan)))),
                                  np.isnan(np.asarray(jnp.linalg.pinv(nan))))
    want = np.asarray(jnp.linalg.pinv(inf))
    assert np.isnan(want).any() and (np.isnan(want) | (want == 0)).all()
    assert np.isnan(_np(pinv(torch.from_numpy(inf)))).all()
    batch = np.stack([a, nan, a])
    got = _np(pinv(torch.from_numpy(batch)))
    assert np.isnan(got[1]).all() and np.isfinite(got[[0, 2]]).all()
    _close(got[[0, 2]], jnp.linalg.pinv(np.stack([a, a])), 1e-5, 1e-6)


@pytest.mark.parametrize("mode", ["faithful", "fast"])
def test_reconstruct_of_a_nan_sketch_is_the_references_nan(mode):
    """The faithful mode raised here before: torch.linalg.pinv refuses a
    non-finite matrix, where the reference returns NaN."""
    rng = np.random.default_rng(1)
    d, k, T, ka = 24, 9, 16, 7
    x, y, z = (rng.standard_normal((d, k)).astype(np.float32)
               for _ in range(3))
    omega = rng.standard_normal((T, k)).astype(np.float32)
    y[5, 2] = np.nan
    want = jax_reconstruct(*map(jnp.asarray, (x, y, z, omega)),
                           jnp.asarray(ka), mode=mode)
    got = reconstruct(*map(torch.from_numpy, (x, y, z, omega)),
                      torch.tensor(ka), mode=mode)
    for g, w in ((got.left, want.left), (got.right, want.right)):
        np.testing.assert_array_equal(np.isnan(_np(g)), np.isnan(w))
    assert np.isnan(_np(got.left)).any()
    _close(got.right, want.right, 1e-5, 1e-6)


def test_corange_reconstruct_of_a_nan_sketch_is_the_references_nan():
    d, nb, ka = 40, 16, 9
    jproj, proj = _proj(d, nb, K_MAX, 2)
    jt, pt = _updated(_low_rank_batches(4, nb, d, 3, 3), jproj, proj, d, nb,
                      ka)
    y = np.array(jt[1])
    y[3, 1] = np.nan
    want = JC.corange_reconstruct(jt[0], jnp.asarray(y), jt[2], jproj,
                                  jnp.asarray(ka))
    got = PC.corange_reconstruct(pt[0], torch.from_numpy(y), pt[2], proj,
                                 torch.tensor(ka))
    for g, w in ((got.left, want.left), (got.right, want.right)):
        np.testing.assert_array_equal(np.isnan(_np(g)), np.isnan(w))
    assert np.isnan(_np(got.right)).all()


# -- the update and the reconstruction ---------------------------------------


@pytest.mark.parametrize("k_active", [5, 9])
def test_corange_update_and_reconstruct_match_reference(k_active):
    d, nb = 40, 16
    jproj, proj = _proj(d, nb, K_MAX, 4)
    rng = np.random.default_rng(5)
    batches = [np.tanh(rng.standard_normal((nb, d))).astype(np.float32)
               for _ in range(4)]
    jt, pt = _updated(batches, jproj, proj, d, nb, k_active)
    for g, w in zip(pt, jt):
        _close(g, w, 1e-5, 1e-6)
    s = 2 * k_active + 1
    assert not pt[0][k_active:].any() and not pt[1][:, k_active:].any()
    assert not pt[2][s:].any() and not pt[2][:, s:].any()
    want = JC.corange_reconstruct(*jt, jproj, jnp.asarray(k_active))
    got = PC.corange_reconstruct(*pt, proj, torch.tensor(k_active))
    _close(got.left, want.left, 1e-5, 1e-5)
    _close(got.right, want.right, 1e-5, 1e-5)
    _close(got.dense(), want.dense(), 1e-5, 1e-5)


def test_corange_recovers_a_low_rank_matrix_as_the_reference():
    """The reference's exact-recovery case: rank-3 EMA matrix, k 9."""
    d, nb, ka, beta = 40, 16, 9, 0.9
    batches = _low_rank_batches(10, nb, d, 3, 6)
    jproj, proj = _proj(d, nb, K_MAX, 7)
    jt, pt = _updated(batches, jproj, proj, d, nb, ka, beta)
    m = sum((1 - beta) * beta ** (len(batches) - 1 - i) * a
            for i, a in enumerate(batches))
    got = _np(PC.corange_reconstruct(*pt, proj, torch.tensor(ka)).dense())
    assert np.linalg.norm(got - m) / np.linalg.norm(m) < 1e-3
    want = JC.corange_reconstruct(*jt, jproj, jnp.asarray(ka)).dense()
    _close(got, want, 1e-5, 1e-5)


def test_batched_reconstruct_is_the_sequential_one():
    """One batched QR and pinv over L stacked layers against L calls."""
    d, nb, ka, L = 40, 16, 9, 3
    _, proj = _proj(d, nb, K_MAX, 10)
    triples = [_updated(_low_rank_batches(3, nb, d, 4, 11 + l), *_proj(
        d, nb, K_MAX, 10), d, nb, ka)[1] for l in range(L)]
    stacked = [torch.stack(t) for t in zip(*triples)]
    got = PC.corange_reconstruct(*stacked, proj, torch.tensor(ka))
    for l, t in enumerate(triples):
        one = PC.corange_reconstruct(*t, proj, torch.tensor(ka))
        torch.testing.assert_close(got.dense()[l], one.dense(), rtol=1e-5,
                                   atol=1e-5 * float(one.dense().abs().max()))


def test_psparse_corange_matrices_are_the_references_bit_for_bit():
    jp = jax_psparse_corange(jax.random.PRNGKey(3), 48, 32, K_MAX, 0.1)
    ours = proj_from_jax(jax.tree.map(np.asarray, jp))
    for name in ("upsilon", "omega", "phi", "psi"):
        want = np.asarray(getattr(jp, name))
        got = _np(getattr(ours, name))
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    dense = proj_from_jax(jax.tree.map(np.asarray, dataclasses.replace(
        jp, density=1.0)))
    assert (np.abs(_np(dense.omega)) == 1.0).all()


# -- the trainer --------------------------------------------------------------


def _jax_batch_fn():
    protos = class_prototypes(jax.random.PRNGKey(50), CFG_KW["d_out"],
                              CFG_KW["d_in"])
    return lambda key: classification_batch(key, protos,
                                            CFG_KW["batch_size"], 1.0)


@functools.lru_cache(maxsize=None)
def _reference(proj_kind: str):
    """The reference's corange ``train`` run, its initial weights and
    tree, and its batches."""
    jcfg = JaxMLPConfig(**CFG_KW)
    jscfg = JaxSketchConfig(**SCFG_KW, proj_kind=proj_kind)
    batch_fn = _jax_batch_fn()
    key = jax.random.PRNGKey(0)
    kp, ks = jax.random.split(key)
    params0 = jax.tree.map(np.asarray, jax_mlp_init(kp, jcfg))
    tree0 = jax.tree.map(np.asarray, JT.init_mlp_sketch(ks, jcfg, jscfg,
                                                        "corange"))
    batches = [tuple(np.asarray(b) for b in batch_fn(jax.random.fold_in(
        key, s))) for s in range(STEPS)]
    res = JT.train(jcfg, jscfg, "corange", steps=STEPS, batch_fn=batch_fn,
                   seed=0)
    return res, params0, tree0, batches


@pytest.mark.parametrize("proj_kind", ["gaussian", "psparse"])
def test_corange_trajectory_matches_reference(proj_kind):
    ref, params0, tree0, batches = _reference(proj_kind)
    ours = PT.train(
        MLPConfig(**CFG_KW), SketchConfig(**SCFG_KW, proj_kind=proj_kind),
        "corange", steps=STEPS,
        batch_fn=lambda s: tuple(torch.tensor(b) for b in batches[s]),
        params=mlp_params_from_jax(params0), sketch=tree_from_jax(tree0),
        device="cpu")
    np.testing.assert_allclose([h["loss"] for h in ours.history],
                               [h["loss"] for h in ref.history], rtol=1e-5)
    node, jnode = ours.sketch.nodes["hidden"], ref.sketch.nodes["hidden"]
    assert node.kind == jnode.kind == "corange"
    for name in "xyz":
        _close(getattr(node, name), getattr(jnode, name), 0, 1e-4)
    _close(ours.monitor.buffer, ref.monitor.buffer, 0, 1e-4)
    for a, b in zip([t for p in ours.params for _, t in sorted(p.items())],
                    jax.tree.leaves(ref.params)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=5e-5)


def test_batched_forward_is_the_sequential_one():
    """``_corange_forward`` both ways from one state: logits, tree and
    weight gradients."""
    _, params0, tree0, batches = _reference("gaussian")
    cfg, scfg = MLPConfig(**CFG_KW), SketchConfig(**SCFG_KW)
    tree = tree_from_jax(tree0)
    x, y = (torch.tensor(b) for b in batches[0])
    outs = []
    for batched in (True, False):
        # a state a few steps in, so the sketches are not zero
        sk = tree
        for s in range(3):
            _, sk = PT._corange_forward(mlp_params_from_jax(params0),
                                        torch.tensor(batches[s][0]), sk, cfg,
                                        scfg, batched=batched)
        live = [{k: v.requires_grad_(True) for k, v in p.items()}
                for p in mlp_params_from_jax(params0)]
        logits, new = PT._corange_forward(live, x, sk, cfg, scfg,
                                          batched=batched)
        grads = torch.autograd.grad(PT.ce_loss(logits, y),
                                    [p["w"] for p in live])
        node = new.nodes["hidden"]
        outs.append([logits, node.x, node.y, node.z, *grads])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-6 * float(b.detach().abs().max()))


def test_lowrank_grad_matmul_grads_and_saved_tensors():
    rng = np.random.default_rng(12)
    T, d_in, d_out, k = 32, 48, 24, 7
    x, left, right = (rng.standard_normal(s).astype(np.float32)
                      for s in ((T, d_in), (T, k), (d_in, k)))
    w = (rng.standard_normal((d_in, d_out)) / 7).astype(np.float32)
    g = rng.standard_normal((T, d_out)).astype(np.float32)
    out, vjp = jax.vjp(lambda x_, w_: JT.lowrank_grad_matmul(
        x_, w_, jnp.asarray(left), jnp.asarray(right)), jnp.asarray(x),
        jnp.asarray(w))
    want_x, want_w = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        got = PT.lowrank_grad_matmul(tx, tw, torch.from_numpy(left),
                                     torch.from_numpy(right))
    _close(got, out, 1e-5, 1e-6)
    (got * torch.from_numpy(g)).sum().backward()
    _close(tx.grad, want_x, 1e-5, 1e-6)
    _close(tw.grad, want_w, 1e-5, 1e-6)
    assert len(saved) == 3 and not any(tuple(t.shape) == (T, d_in)
                                       for t in saved)


@pytest.mark.parametrize("proj_kind", ["gaussian", "psparse"])
def test_tree_helpers_take_a_corange_tree(proj_kind):
    """Bytes and monitor rows as the reference's; a copy and a refresh
    keep the node's kind and shapes."""
    _, _, tree0, _ = _reference(proj_kind)
    jtree = jax.tree.map(jnp.asarray, tree0)
    tree = tree_from_jax(tree0)
    assert tree_memory_bytes(tree) == jax_tree_bytes(jtree)
    tree.nodes["hidden"].y += 1.0
    jtree.nodes["hidden"].y = jtree.nodes["hidden"].y + 1.0
    _close(tree_metrics(tree), jax_tree_metrics(jtree), 1e-5, 1e-6)
    moved = tree_to(tree, "cpu")
    new = refresh_tree(tree)
    for t in (moved, new):
        node = t.nodes["hidden"]
        assert node.kind == "corange"
        assert [tuple(getattr(node, a).shape) for a in "xyzp" if a != "p"] \
            == [tuple(getattr(tree.nodes["hidden"], a).shape) for a in "xyz"]
    assert not new.nodes["hidden"].y.any()
    assert not torch.equal(new.proj.omega, tree.proj.omega)
    assert new.proj.omega.shape == tree.proj.omega.shape
