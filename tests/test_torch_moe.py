"""The port's MoE layer, its stacked sketch update and the NodeSpec
registry against the JAX package, on the CPU.

Routing and dispatch at T 37 tokens, E 4 and 8 experts, top-2, from
numpy draws of a seed: ``route``'s choices and ``dispatch_meta``'s slot
tokens and validity must equal the reference's exactly, also where two
router columns are equal (every token's two probabilities tie: the
lower expert goes first, as ``jax.lax.top_k`` orders them) and where a
capacity factor of 0.5 drops choices; the weights and the load-balance
loss within rtol 1e-6. ``moe_apply_ref`` in f32 within rtol 1e-5 of the
reference's output, and its router and expert gradients within rtol
1e-5 of ``jax.vjp``'s; without drops it equals the port's
``moe_dense_ref``.

The "expert_in" update (``models.transformer._update_expert_triple``,
one stacked kernel call, here its plain version) against the
reference's vmapped ``_update_expert_triple``, with Gaussian and
psparse projections, with slabs of fewer rows than the binding and of
more: each triple within rtol 1e-5, atol 1e-5 * max|reference|.

``node_specs_for`` on every registered architecture equals the
reference's, widths and stacks; the monitor's paths of an (L, E) stack
are the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.configs.paper import CIFAR_CONV as JAX_CIFAR_CONV
from repro.configs.paper import MNIST_MLP as JAX_MNIST_MLP
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.sketches import NodeSpec as JNodeSpec
from repro.sketches import init_node_tree as jax_init_node_tree
from repro.sketches import node_paths as jax_node_paths
from repro.sketches.registry import node_specs_for as jax_node_specs_for
from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.configs.paper import CIFAR_CONV, MNIST_MLP
from repro_torch.interop import tree_from_jax
from repro_torch.kernels.psparse_update import (
    psparse_update, psparse_update_ref,
)
from repro_torch.kernels.sketch_update import sketch_update, sketch_update_ref
from repro_torch.models import moe
from repro_torch.models import transformer
from repro_torch.sketches import node_paths
from repro_torch.sketches.registry import (
    family_for, node_specs_for, register_node_specs, registered_families,
)
from repro_torch.train.state import RunConfig
from repro_torch.train.step import make_dp_train_step

T, D, F_FF, K = 37, 16, 24, 2
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(E, capacity_factor=1.25):
    """An MoE config of E experts at d 16 (the port's and the
    reference's), top-2."""
    j = dataclasses.replace(jax_reduced(jax_get_arch("qwen3-moe-30b-a3b")),
                            d_model=D, d_ff=F_FF, num_experts=E,
                            experts_per_token=K,
                            capacity_factor=capacity_factor)
    t = dataclasses.replace(reduced(get_arch("qwen3-moe-30b-a3b")),
                            d_model=D, d_ff=F_FF, num_experts=E,
                            experts_per_token=K,
                            capacity_factor=capacity_factor)
    return j, t


def _params(E, seed, tie=False):
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((D, E)) / np.sqrt(D),
         "we_gate": rng.standard_normal((E, D, F_FF)) / np.sqrt(D),
         "we_up": rng.standard_normal((E, D, F_FF)) / np.sqrt(D),
         "we_down": rng.standard_normal((E, F_FF, D)) / np.sqrt(F_FF)}
    if tie:     # experts 1 and 2 always tie
        p["router"][:, 2] = p["router"][:, 1]
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((T, D)).astype(np.float32)
    return p, x


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, rtol=TOL, atol_rel=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(
        _np(got), want, rtol=rtol,
        atol=atol_rel * max(float(np.abs(want).max()), 1e-30))


CASES = [(4, 1.25, False), (8, 1.25, False), (4, 1.25, True),
         (8, 1.25, True), (4, 0.5, False), (8, 0.5, True)]


@pytest.mark.parametrize("E,cf,tie", CASES)
def test_route_and_dispatch_match_reference(E, cf, tie):
    jcfg, cfg = _cfg(E, cf)
    p, x = _params(E, seed=E + 10 * tie, tie=tie)
    C = moe.capacity(T, E, K, cf)
    assert C == jmoe.capacity(T, E, K, cf)
    jprobs, jtopw, jtope = jax.jit(jmoe.route, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(p["router"]), K)
    probs, topw, tope = moe.route(torch.from_numpy(x),
                                  torch.from_numpy(p["router"]), K)
    if tie:     # the tie is real on both sides, and decides choices
        assert np.array_equal(_np(probs)[:, 1], _np(probs)[:, 2])
        assert np.array_equal(np.asarray(jprobs)[:, 1],
                              np.asarray(jprobs)[:, 2])
        assert ((_np(tope) == 1).any(1) != (_np(tope) == 2).any(1)).any()
    np.testing.assert_array_equal(_np(tope), np.asarray(jtope))
    _close(probs, jprobs, rtol=1e-6, atol_rel=0)
    _close(topw, jtopw, rtol=1e-6, atol_rel=0)
    jtok, jwgt, jvalid = jmoe.dispatch_meta(jtope, jtopw, E, C)
    tok, valid, slot = moe.dispatch_meta(tope, E, C)
    np.testing.assert_array_equal(_np(tok), np.asarray(jtok))
    np.testing.assert_array_equal(_np(valid), np.asarray(jvalid))
    wgt = torch.zeros(E * C + 1).index_put_((slot.reshape(-1),),
                                            topw.reshape(-1))[:E * C]
    _close(wgt, jwgt, rtol=1e-6, atol_rel=0)
    dropped = int((slot == E * C).sum())
    assert dropped == T * K - int(valid.sum())
    assert dropped > 0 or cf > 1     # capacity 0.5 drops choices
    _close(moe.aux_load_balance(probs, tope, E),
           jmoe.aux_load_balance(jprobs, jtope, E), rtol=1e-6, atol_rel=0)


@pytest.mark.parametrize("E,cf,tie", [(4, 1.25, True), (8, 0.5, False)])
def test_moe_apply_and_gradients_match_reference(E, cf, tie):
    jcfg, cfg = _cfg(E, cf)
    p, x = _params(E, seed=3 + E, tie=tie)
    g = np.random.default_rng(9).standard_normal((T, D)).astype(np.float32)

    def jloss(pp, xx):
        y, aux = jmoe.moe_apply_ref(pp, xx, jcfg)
        return jnp.sum(y * g) + 0.5 * aux

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jy, jaux = jax.jit(lambda pp, xx: jmoe.moe_apply_ref(pp, xx, jcfg))(
        jp, jnp.asarray(x))
    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux, xg = moe.moe_apply_ref(tp, tx, cfg, return_dispatch=True)
    _close(y, jy)
    _close(aux, jaux, rtol=1e-6, atol_rel=0)
    _, _, jxg = jmoe.moe_apply_ref(jp, jnp.asarray(x), jcfg,
                                   return_dispatch=True)
    np.testing.assert_array_equal(_np(xg), np.asarray(jxg))
    loss = (y * torch.from_numpy(g)).sum() + 0.5 * aux
    grads = torch.autograd.grad(loss, [*tp.values(), tx])
    for name, got in zip([*tp, "x"], grads):
        want = jgrads[1] if name == "x" else jgrads[0][name]
        _close(got, want)


def test_moe_apply_ref_equals_dense_oracle_without_drops():
    _, cfg = _cfg(8, capacity_factor=8.0)
    p, x = _params(8, seed=4)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    y, _ = moe.moe_apply_ref(tp, tx, cfg)
    _close(y, _np(moe.moe_dense_ref(tp, tx, cfg)))
    # (B, S, d) through moe_apply is the same over the B*S tokens
    yb, _ = moe.moe_apply(tp, tx.reshape(1, T, D), cfg)
    assert torch.equal(yb.reshape(T, D), y)


# ---------------------------------------------------------------------------
# the "expert_in" stack's update
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("proj_kind", ["gaussian", "psparse"])
@pytest.mark.parametrize("rows", [20, 64, 90])
def test_expert_update_matches_reference(proj_kind, rows):
    """E 4 experts at d 16, k 9 against a binding of 64 rows: slabs of
    20 rows (the projections' first 20), 64, and 90 (the reference cuts
    them to 64; a real slab's rows past an expert's count are zero)."""
    E, d, k, binding = 4, 16, 9, 64
    jtree = jax_init_node_tree(
        jax.random.PRNGKey(6), {"expert_in": JNodeSpec(width=d, layers=E)},
        binding, k, proj_kind=proj_kind)
    rng = np.random.default_rng(rows)
    node = jtree.nodes["expert_in"]
    node = dataclasses.replace(node, **{
        a: jnp.asarray(rng.standard_normal((E, d, k)), jnp.float32)
        for a in "xyz"})
    xg = rng.standard_normal((E, rows, d)).astype(np.float32)
    xg[:, 60:] = 0.0
    jtree = dataclasses.replace(jtree, rank=jnp.asarray(3, jnp.int32),
                                nodes={"expert_in": node})
    st = dict(beta=0.9)
    want = jtransformer._update_expert_triple(
        node, jnp.asarray(xg), jtree.proj, jtree.k_active,
        jtransformer.SketchSettings(**st))
    tree = tree_from_jax(jax.tree.map(np.asarray, jtree))
    got = transformer._update_expert_triple(
        tree.nodes["expert_in"], torch.from_numpy(xg), tree.proj,
        tree.k_active, transformer.SketchSettings(**st))
    for a in "xyz":
        _close(getattr(got, a), getattr(want, a))
    # increments under the deferred layout: the update from zero sketches
    inc = transformer._update_expert_triple(
        tree.nodes["expert_in"], torch.from_numpy(xg), tree.proj,
        tree.k_active, transformer.SketchSettings(dp_defer=True, **st))
    jinc = jtransformer._update_expert_triple(
        node, jnp.asarray(xg), jtree.proj, jtree.k_active,
        jtransformer.SketchSettings(dp_defer=True, **st))
    for a in "xyz":
        _close(getattr(inc, a), getattr(jinc, a))


def test_stacked_plain_versions_are_the_unstacked_ones_in_turn():
    """One stacked plain call equals E unstacked calls, expert by
    expert, for both projection kinds, also with fewer rows than the
    psparse binding."""
    from repro_torch.kernels.psparse_update import psparse_hash_params
    g = torch.Generator().manual_seed(3)
    E, rows, d, k = 3, 40, 12, 5
    a = torch.randn((E, rows, d), generator=g)
    x, y, z = (torch.randn((E, d, k), generator=g) for _ in range(3))
    psi = torch.randn((E, k), generator=g)
    ups, omg, phi = (torch.randn((rows, k), generator=g) for _ in range(3))
    got = sketch_update_ref(a, x, y, z, ups, omg, phi, psi, 0.9)
    for e in range(E):
        want = sketch_update_ref(a[e], x[e], y[e], z[e], ups, omg, phi,
                                 psi[e], 0.9)
        for gt, w in zip(got, want):
            torch.testing.assert_close(gt[e], w, rtol=1e-6, atol=1e-6)
    # the wrapper checks the stack before any launch
    with pytest.raises(ValueError, match="sketches must be"):
        sketch_update(a, x[0], y[0], z[0], ups, omg, phi, psi[0], beta=0.9)
    with pytest.raises(ValueError, match="psi must have shape"):
        sketch_update(a, x, y, z, ups, omg, phi, psi[0], beta=0.9)
    params = psparse_hash_params(g)
    with pytest.raises(ValueError, match="sketches must be"):
        psparse_update(a, x[:2], y, z, params, psi, beta=0.9, m=11,
                       num_tokens=64)
    got = psparse_update_ref(a, x, y, z, params, psi, beta=0.9, m=11,
                             num_tokens=64)
    for e in range(E):
        want = psparse_update_ref(a[e], x[e], y[e], z[e], params, psi[e],
                                  beta=0.9, m=11, num_tokens=64)
        for gt, w in zip(got, want):
            torch.testing.assert_close(gt[e], w, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def _spec_tuple(specs):
    return {n: (s.width, s.layers) for n, s in specs.items()}


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("mode", ["backprop", "monitor"])
def test_node_specs_match_reference(name, mode):
    for ours, ref in ((get_arch(name), jax_get_arch(name)),
                      (reduced(get_arch(name)),
                       jax_reduced(jax_get_arch(name)))):
        ours = dataclasses.replace(ours, sketch_mode=mode)
        ref = dataclasses.replace(ref, sketch_mode=mode)
        assert family_for(ours) == \
            __import__("repro.sketches.registry",
                       fromlist=["family_for"]).family_for(ref)
        assert _spec_tuple(node_specs_for(ours)) == \
            _spec_tuple(jax_node_specs_for(ref))


def test_paper_configs_resolve_through_the_registry():
    assert family_for(MNIST_MLP) == "mlp" and family_for(CIFAR_CONV) == "conv"
    assert _spec_tuple(node_specs_for(MNIST_MLP)) == \
        _spec_tuple(jax_node_specs_for(JAX_MNIST_MLP))
    assert _spec_tuple(node_specs_for(CIFAR_CONV)) == \
        _spec_tuple(jax_node_specs_for(JAX_CIFAR_CONV))
    assert set(registered_families()) >= {"lm", "moe", "recurrent", "mlp",
                                          "conv"}
    with pytest.raises(TypeError, match="no NodeSpec family"):
        family_for(object())
    with pytest.raises(ValueError):
        register_node_specs("", lambda cfg: {})


def test_expert_stack_paths_and_metrics_rows_match_reference():
    """An (L, E) stack's monitor rows: the reference's paths, one row
    of tree_metrics each."""
    from repro_torch.core.monitor import tree_metrics
    jcfg = jax_reduced(jax_get_arch("qwen3-moe-30b-a3b"))
    jtree = jtransformer.init_lm_sketch_state(
        jax.random.PRNGKey(0), jcfg,
        jtransformer.SketchSettings(enabled=True, k_max=9), 32)
    tree = tree_from_jax(jax.tree.map(np.asarray, jtree))
    paths = node_paths(tree)
    assert paths == jax_node_paths(jtree)
    assert "block1/expert_in/3" in paths
    assert tree_metrics(tree).shape == (len(paths), 3)
    assert tree.nodes["expert_in"].psi.shape == (2, 4, 9)


def test_dp_step_refuses_moe_naming_its_roadmap_item():
    cfg = reduced(get_arch("qwen3-moe-30b-a3b"))
    run = RunConfig(seq_len=16, global_batch=2, dp_axis_name="data",
                    dp_workers=2)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP A17, MoE data-parallel"):
        make_dp_train_step(cfg, run)
