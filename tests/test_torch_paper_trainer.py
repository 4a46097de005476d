"""The port's paper MLP trainer and its pieces against the JAX reference,
on the CPU, at the reference tests' small size (32 -> 48 x3 -> 4, tanh,
batch 32, rank 3 of 6).

Both packages get the same numbers: weights, sketch trees and batches
are made on the JAX side and carried over with ``repro_torch.interop``;
other inputs are drawn with numpy. Tolerances, all f32 on both sides
with sums taken in other orders:
  * reconstruction factors and sketched gradients: rtol 1e-4, atol 1e-5
    * max|reference| (QR, pinv or a k x k solve amplify rounding by the
    sketch's condition number, here below 1e3);
  * Adam: rtol 1e-6, atol 1e-7 (one elementwise step);
  * trajectories: losses rtol 1e-5; parameters atol 5e-5 after 20 Adam
    steps of lr 2e-3 (observed: 2e-7 Gaussian, 7e-6 psparse); sketches
    and the metrics ring atol 1e-4 * max|reference|; ranks exact.
The psparse trajectory runs at seed 22, where all three of the
reference's sign matrices have full rank over the active columns: for
most seeds at this size they do not (ROADMAP §C), the sketch Y is rank
deficient and the reconstruction follows rounding in both packages.
``test_psparse_rank_deficient_seed`` pins that case down.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper import MLPConfig as JaxMLPConfig
from repro.core.adaptive import AdaptiveConfig as JaxAdaptiveConfig
from repro.core.adaptive import adaptive_step as jax_adaptive_step
from repro.core.adaptive import init_adaptive_state as jax_init_adaptive
from repro.core.reconstruct import reconstruct as jax_reconstruct
from repro.core.reconstruct import \
    reconstruct_dense_faithful as jax_reconstruct_dense
from repro.core.sketch import SketchConfig as JaxSketchConfig
from repro.data.synthetic import class_prototypes, classification_batch
from repro.models.mlp import mlp_init as jax_mlp_init
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.optim.adamw import init_adamw as jax_init_adamw
from repro.sketches.linear import sketched_matmul as jax_sketched_matmul
from repro.train import paper_trainer as JT
from repro_torch.configs.paper import MLPConfig
from repro_torch.core.adaptive import (
    AdaptiveConfig, adaptive_step, init_adaptive_state,
)
from repro_torch.core.reconstruct import (
    reconstruct, reconstruct_dense_faithful,
)
from repro_torch.core.sketch import SketchConfig
from repro_torch.interop import (
    adamw_state_from_jax, mlp_params_from_jax, tree_from_jax,
)
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.sketches.linear import sketched_matmul
from repro_torch.sketches.tree import refresh_tree
from repro_torch.train import paper_trainer as PT

CFG_KW = dict(name="t", d_in=32, d_hidden=48, d_out=4, num_hidden_layers=3,
              activation="tanh", batch_size=32, learning_rate=2e-3)
SCFG_KW = dict(rank=3, max_rank=6, beta=0.9, batch_size=32,
               recon_mode="fast")
ADAPTIVE_KW = dict(r0=3, r_min=1, r_max=6, patience_decrease=2,
                   patience_increase=3)
STEPS = 20
EPOCH = 2                      # adaptive controller every 2 steps
PSPARSE_SEED = 22


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, rtol, atol_rel):
    want = np.asarray(want)
    np.testing.assert_allclose(
        _np(got), want, rtol=rtol,
        atol=atol_rel * max(float(np.abs(want).max()), 1e-30))


def _triple(d, k, k_active, T, seed):
    """A (d, k) triple observed on a (T, d) batch, columns masked."""
    rng = np.random.default_rng(seed)
    a = np.tanh(rng.standard_normal((T, d))).astype(np.float32)
    proj = rng.standard_normal((4, T, k)).astype(np.float32)
    psi = rng.standard_normal(k).astype(np.float32)
    mask = (np.arange(k) < k_active).astype(np.float32)
    x, y, z = (a.T @ p * mask for p in proj[:3])
    return a, x, y, z * psi, proj[1] * mask


@pytest.mark.parametrize("mode", ["faithful", "fast"])
@pytest.mark.parametrize("k_active", [3, 7])
def test_reconstruct_matches_reference(mode, k_active):
    a, x, y, z, omega = _triple(48, 13, k_active, 32, seed=k_active)
    want = jax_reconstruct(*map(jnp.asarray, (x, y, z, omega)),
                           jnp.asarray(k_active), mode=mode)
    got = reconstruct(*map(torch.from_numpy, (x, y, z, omega)),
                      torch.tensor(k_active), mode=mode)
    _close(got.left, want.left, 1e-4, 1e-5)
    _close(got.right, want.right, 1e-4, 1e-5)
    _close(got.dense(), want.dense(), 1e-4, 1e-5)
    dense = reconstruct_dense_faithful(*map(torch.from_numpy,
                                            (x, y, z, omega)),
                                       torch.tensor(k_active), mode=mode)
    _close(dense, jax_reconstruct_dense(*map(jnp.asarray, (x, y, z, omega)),
                                        jnp.asarray(k_active), mode=mode),
           1e-4, 1e-5)
    assert not got.left[:, k_active:].any()


@pytest.mark.parametrize("factored", [True, False])
def test_sketched_matmul_grads_and_saved_tensors(factored):
    T, d_in, d_out, k_active = 32, 48, 24, 5
    a, x, y, z, omega = _triple(d_in, 13, k_active, T, seed=3)
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((d_in, d_out)) / 7).astype(np.float32)
    g = rng.standard_normal((T, d_out)).astype(np.float32)

    def jloss(h, w_):
        out = jax_sketched_matmul(h, w_, *map(jnp.asarray, (x, y, z, omega)),
                                  jnp.asarray(k_active), "faithful", 1e-4,
                                  factored)
        return jnp.sum(out * g)

    want_h, want_w = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a),
                                                     jnp.asarray(w))
    th = torch.from_numpy(a).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        out = sketched_matmul(th, tw, *map(torch.from_numpy,
                                           (x, y, z, omega)),
                              torch.tensor(k_active), "faithful", 1e-4,
                              factored)
    _close(out, a @ w, 1e-5, 1e-6)
    (out * torch.from_numpy(g)).sum().backward()
    _close(th.grad, want_h, 1e-4, 1e-5)
    _close(tw.grad, want_w, 1e-4, 1e-5)
    assert saved and not any(tuple(t.shape) == (T, d_in) for t in saved)
    assert not any(t.data_ptr() == th.data_ptr() for t in saved)


def test_adamw_update_matches_reference():
    rng = np.random.default_rng(5)
    shapes = [((6, 4), (4,)), ((4, 3), (3,))]
    f = lambda s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)
    params = [{"w": f(w), "bias": f(b)} for w, b in shapes]
    grads = [{"w": f(w, 3.0), "bias": f(b, 3.0)} for w, b in shapes]
    jcfg = JaxAdamWConfig(lr=2e-3, b2=0.999, weight_decay=0.01)
    cfg = AdamWConfig(lr=2e-3, b2=0.999, weight_decay=0.01)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jax_init_adamw(jp, jcfg)
    for _ in range(2):   # the second step starts from non-zero moments
        jstate_np = jax.tree.map(np.asarray, jstate)
        jp_np = jax.tree.map(np.asarray, jp)
        jp, jstate, jmet = jax.jit(jax_adamw_update, static_argnums=3)(
            jp, jax.tree.map(jnp.asarray, grads), jstate, jcfg)
    p, state, met = adamw_update(
        mlp_params_from_jax(jp_np), mlp_params_from_jax(grads),
        adamw_state_from_jax(jstate_np), cfg)
    for ours, ref in ((p, jp), (state["m"], jstate["m"]),
                      (state["v"], jstate["v"])):
        for lo, lr in zip(ours, ref):
            for key in lo:
                _close(lo[key], lr[key], 1e-6, 1e-7)
    assert int(state["count"]) == int(jstate["count"]) == 2
    _close(met["grad_norm"], jmet["grad_norm"], 1e-6, 1e-7)


def test_adaptive_step_gives_the_reference_ranks():
    """A fixed metric sequence with improving, stalling and reset
    stretches: the same ranks, changes and streaks at every epoch."""
    metrics = [3.0, 2.5, 2.0, 1.9, 1.9, 1.9, 1.9, 1.95, 1.2, 1.1, 1.0,
               0.99995, 0.99994, 1.5, 1.5, 1.5, 1.5, 1.5, 1.5, 1.5, 1.5]
    jcfg = JaxAdaptiveConfig(r0=3, r_max=8, patience_decrease=2,
                             patience_increase=3, tau_reset=8)
    cfg = AdaptiveConfig(r0=3, r_max=8, patience_decrease=2,
                         patience_increase=3, tau_reset=8)
    jstate, jrank = jax_init_adaptive(), jnp.asarray(3, jnp.int32)
    state, rank = init_adaptive_state(), 3
    ranks = []
    for mt in metrics:
        jstate, jrank, jchanged = jax_adaptive_step(
            jstate, jrank, jnp.asarray(mt, jnp.float32), jcfg)
        state, rank, changed = adaptive_step(state, rank, mt, cfg)
        assert rank == int(jrank) and changed == bool(jchanged)
        assert state.streak_improve == int(jstate.streak_improve)
        assert state.streak_stall == int(jstate.streak_stall)
        assert state.best_metric == float(jstate.best_metric)
        ranks.append(rank)
    assert len(set(ranks)) > 2 and state.num_changes == int(
        jstate.num_changes)


# -- 20-step trajectories ----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_run(variant: str, proj_kind: str, seed: int):
    """The reference's ``train`` and the inputs the port needs to replay
    it: its initial weights and tree, and its batches."""
    jcfg = JaxMLPConfig(**CFG_KW)
    jscfg = JaxSketchConfig(**SCFG_KW, proj_kind=proj_kind)
    protos = class_prototypes(jax.random.PRNGKey(50), jcfg.d_out, jcfg.d_in)

    def batch_fn(key):
        return classification_batch(key, protos, jcfg.batch_size, 1.0)

    key = jax.random.PRNGKey(seed)
    kp, ks = jax.random.split(key)
    params0 = jax.tree.map(np.asarray, jax_mlp_init(kp, jcfg))
    tree0 = jax.tree.map(np.asarray, JT.init_mlp_sketch(ks, jcfg, jscfg,
                                                        variant))
    batches = [tuple(np.asarray(b) for b in batch_fn(jax.random.fold_in(key,
                                                                        s)))
               for s in range(STEPS)]
    res = JT.train(jcfg, jscfg, variant, steps=STEPS, batch_fn=batch_fn,
                   seed=seed, eval_fn=lambda p: {}, steps_per_epoch=EPOCH,
                   adaptive=JaxAdaptiveConfig(**ADAPTIVE_KW))
    return res, params0, tree0, batches


def _port_run(variant, proj_kind, seed):
    res, params0, tree0, batches = _reference_run(variant, proj_kind, seed)
    ours = PT.train(
        MLPConfig(**CFG_KW), SketchConfig(**SCFG_KW, proj_kind=proj_kind),
        variant, steps=STEPS,
        batch_fn=lambda s: tuple(torch.tensor(b) for b in batches[s]),
        eval_fn=lambda p: {}, steps_per_epoch=EPOCH,
        adaptive=AdaptiveConfig(**ADAPTIVE_KW),
        params=mlp_params_from_jax(params0), sketch=tree_from_jax(tree0),
        device="cpu")
    return ours, res


def _param_leaves(params):
    return [t for layer in params for _, t in sorted(layer.items())]


RUNS = [("standard", "gaussian", 0), ("monitor", "gaussian", 0),
        ("sketched_fixed", "gaussian", 0),
        ("sketched_fixed", "psparse", PSPARSE_SEED)]


@pytest.mark.parametrize("variant,proj_kind,seed", RUNS,
                         ids=[f"{v}-{p}" for v, p, _ in RUNS])
def test_trajectory_matches_reference(variant, proj_kind, seed):
    ours, ref = _port_run(variant, proj_kind, seed)
    np.testing.assert_allclose([h["loss"] for h in ours.history],
                               [h["loss"] for h in ref.history], rtol=1e-5)
    assert [h["rank"] for h in ours.history] == \
        [h["rank"] for h in ref.history]
    for a, b in zip(_param_leaves(ours.params), jax.tree.leaves(ref.params)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=5e-5)
    if variant == "standard":
        return
    node, jnode = ours.sketch.nodes["hidden"], ref.sketch.nodes["hidden"]
    for name in "xyz":
        _close(getattr(node, name), getattr(jnode, name), 0, 1e-4)
    assert ours.sketch.step == int(ref.sketch.step) == STEPS
    _close(ours.monitor.buffer, ref.monitor.buffer, 0, 1e-4)
    assert ours.monitor.count == int(ref.monitor.count)


def test_adaptive_trajectory_matches_reference_up_to_its_refresh():
    """The reference re-derives projections with ``fold_in`` at a rank
    change, which torch cannot replay: the two runs are held together up
    to the first refresh (losses and ranks) and must refresh at the same
    step; after it the port's tree is a fresh one (zero sketches, new
    projections, the next epoch)."""
    ours, ref = _port_run("sketched_adaptive", "gaussian", 0)
    ranks = [h["rank"] for h in ref.history]
    first = next(i for i, r in enumerate(ranks) if r != ranks[0])
    assert [h["rank"] for h in ours.history[:first + 1]] == ranks[:first + 1]
    np.testing.assert_allclose([h["loss"] for h in ours.history[:first + 1]],
                               [h["loss"] for h in ref.history[:first + 1]],
                               rtol=1e-5)
    assert ours.sketch.epoch >= 1


def test_refresh_tree_zeroes_and_redraws():
    _, _, tree0, _ = _reference_run("sketched_adaptive", "gaussian", 0)
    tree = tree_from_jax(tree0)
    tree.nodes["hidden"].x += 1.0
    new = refresh_tree(tree)
    node, old = new.nodes["hidden"], tree.nodes["hidden"]
    assert not node.x.any() and not node.y.any() and not node.z.any()
    assert not torch.equal(node.psi, old.psi)
    assert not torch.equal(new.proj["omega"], tree.proj["omega"])
    assert (new.epoch, new.step) == (tree.epoch + 1, 0)
    assert new.proj["omega"].shape == tree.proj["omega"].shape
    again = refresh_tree(tree)          # same seed and epoch: same draws
    assert torch.equal(again.proj["omega"], new.proj["omega"])


def test_monitor_leaves_params_equal_to_standard():
    std, _ = _port_run("standard", "gaussian", 0)
    mon, _ = _port_run("monitor", "gaussian", 0)
    for a, b in zip(_param_leaves(std.params), _param_leaves(mon.params)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-6)
    assert float(mon.sketch.nodes["hidden"].y.abs().max()) > 0.0


def test_psparse_rank_deficient_seed():
    """At seed 0 the reference's omega sign matrix over the 7 active
    columns has rank 3, so every omega-sketch Y it makes has rank <= 3
    and the reconstruction's QR columns past it follow rounding. The
    port reproduces those signs bit for bit; its updates on them are
    held against the reference in test_torch_psparse_update.py."""
    jcfg = JaxMLPConfig(**CFG_KW)
    jscfg = JaxSketchConfig(**SCFG_KW, proj_kind="psparse")
    _, ks = jax.random.split(jax.random.PRNGKey(0))
    jtree = JT.init_mlp_sketch(ks, jcfg, jscfg, "sketched_fixed")
    tree = tree_from_jax(jax.tree.map(np.asarray, jtree))
    signs = tree.proj.signs("omega")[:, :7]
    np.testing.assert_array_equal(signs.numpy(),
                                  np.asarray(jtree.proj.signs("omega"))[:, :7])
    assert int(torch.linalg.matrix_rank(signs)) == 3


def test_unported_variant_names_its_roadmap_item():
    """Every variant trains now; the data-parallel step refuses corange
    with the reference's ValueError and message."""
    with pytest.raises(ValueError, match="paper-kind variants") as ours:
        PT.make_dp_step(MLPConfig(**CFG_KW), SketchConfig(**SCFG_KW),
                        "corange", AdamWConfig(), 4)
    with pytest.raises(ValueError) as ref:
        JT.make_dp_step(JaxMLPConfig(**CFG_KW), JaxSketchConfig(**SCFG_KW),
                        "corange", JaxAdamWConfig(), None)
    assert str(ours.value) == str(ref.value)
    PT.make_step(MLPConfig(**CFG_KW), SketchConfig(**SCFG_KW), "corange",
                 AdamWConfig())


@pytest.mark.parametrize("proj_kind", ["gaussian", "psparse"])
def test_tree_memory_bytes_matches_reference(proj_kind):
    """Sketches, psi and projections (12 uint32 coefficients for a
    psparse tree) are the same bytes in both packages."""
    from repro.sketches.tree import tree_memory_bytes as jax_bytes
    from repro_torch.sketches.tree import tree_memory_bytes
    jcfg = JaxMLPConfig(**CFG_KW)
    jscfg = JaxSketchConfig(**SCFG_KW, proj_kind=proj_kind)
    jtree = JT.init_mlp_sketch(jax.random.PRNGKey(1), jcfg, jscfg,
                               "sketched_fixed")
    tree = tree_from_jax(jax.tree.map(np.asarray, jtree))
    assert tree_memory_bytes(tree) == jax_bytes(jtree)
