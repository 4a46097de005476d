"""The port's flat-segment wire (``sketches.wire``) and its collectives
(``parallel.collectives``) against the JAX reference's, on the CPU: the
segment layout and the packed buffers of the reduced tinyllama-1.1b's
sketch increments and of the fused step's segment dict, the overlap
partition, the simulated int8 wire and its byte count, exactly; then
the merges over W workers: the psum is the ordered fold, the fp32 ring
the same bits, the int8 ring's residual ledgers conserve the mass.

Inputs are the reference's NodeTree and parameters (drawn with
jax.random and carried over with ``repro_torch.interop``) and numpy
draws. Tolerance: none but for the ledger, which is held to 8 W ulps of
the largest element.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.models.transformer import SketchSettings as JSketchSettings
from repro.models.transformer import init_lm_sketch_state
from repro.models.transformer import init_params as jax_init_params
from repro.sketches import wire as JW
from repro_torch import interop
from repro_torch.configs import get_arch, reduced
from repro_torch.optim.flat import FlatLayout
from repro_torch.models.transformer import flat_paths
from repro_torch.parallel import collectives as C
from repro_torch.sketches import wire as TW


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def trees():
    """The reference's increment leaves (random values in the tree's
    shapes) and parameters, and the port's copies."""
    jcfg = jax_reduced(jax_get_arch("tinyllama-1.1b"))
    jtree = init_lm_sketch_state(jax.random.PRNGKey(0), jcfg,
                                 JSketchSettings(enabled=True, k_max=9), 32)
    rng = np.random.default_rng(0)
    jinc = jax.tree.map(
        lambda a: jnp.asarray((rng.standard_normal(a.shape) * 10.0 **
                               rng.integers(-3, 3, a.shape[:-1] + (1,)))
                              .astype(np.float32)),
        JW.tree_increment_leaves(jtree))
    jparams = jax_init_params(jax.random.PRNGKey(1), jcfg)
    inc = {n: {a: torch.tensor(np.asarray(v)) for a, v in leaves.items()}
           for n, leaves in jinc.items()}
    params = interop.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jinc, inc, jparams, params


def test_increment_layout_and_buffer_are_the_references(trees):
    jinc, inc, _, _ = trees
    jspec, spec = JW.segment_spec(jinc), TW.segment_spec(inc)
    assert spec.offsets == jspec.offsets and spec.total == jspec.total
    assert spec.shapes == jspec.shapes and spec.wire_bytes == jspec.wire_bytes
    assert spec.num_segments == jspec.num_segments
    flat = TW.pack_segments(inc)
    assert np.array_equal(flat.numpy(), np.asarray(JW.pack_segments(jinc)))
    back = TW.unpack_segments(spec, flat)
    for n in inc:
        for a in "xyz":
            assert torch.equal(back[n][a], inc[n][a])
    assert TW.int8_segment_bytes(spec) == JW.int8_segment_bytes(jspec)


def test_fused_segment_dict_packs_as_the_references(trees):
    """Keys sorted (grads, n, scalars, sketch), gradients in the
    reference's ravel order: the same buffer, element for element."""
    jinc, inc, jparams, params = trees
    jseg = {"n": jnp.ones(()), "scalars": jnp.asarray([5.0, 4.5, 0.0]),
            "sketch": jinc, "grads": jparams}
    cfg = reduced(get_arch("tinyllama-1.1b"))
    lay = FlatLayout(params, flat_paths(params, cfg))
    seg = {"n": torch.ones(()), "scalars": torch.tensor([5.0, 4.5, 0.0]),
           "sketch": inc, "grads": lay.leaves(params)}
    want = np.asarray(JW.pack_segments(jseg))
    got = TW.pack_segments(seg)
    assert np.array_equal(got.numpy(), want)
    out = torch.empty_like(got)
    assert torch.equal(TW.pack_segments(seg, out=out), got)
    jspec, spec = JW.segment_spec(jseg), TW.segment_spec(seg)
    assert spec.total == jspec.total
    # every reference segment starts where one of the port's does (the
    # port's gradient leaves are per layer, the reference's stacked)
    assert set(jspec.offsets) <= set(spec.offsets)
    n_grads = len(lay.paths)
    assert spec.offsets[n_grads:] == jspec.offsets[-len(spec.offsets)
                                                   + n_grads:]
    early, late = TW.partition_segments(seg)
    jearly, jlate = JW.partition_segments(jseg)
    assert sorted(early) == sorted(jearly) and sorted(late) == sorted(jlate)
    assert TW.OVERLAP_EARLY_KEYS == JW.OVERLAP_EARLY_KEYS


def test_fake_quantize_tree_is_the_jitted_references(trees):
    """The reference's DP step runs it jitted, where XLA:CPU multiplies
    by fl(1/127) and contracts the residual into an FMA: bit for bit."""
    jinc, inc, _, _ = trees
    jd, jr = jax.jit(JW.fake_quantize_tree)(jinc)
    d, r = TW.fake_quantize_tree(inc)
    for n in inc:
        for a in "xyz":
            assert np.array_equal(_np(d[n][a]), np.asarray(jd[n][a]))
            assert np.array_equal(_np(r[n][a]), np.asarray(jr[n][a]))


def _workers(seed, W):
    rng = np.random.default_rng(seed)
    return [{"a": torch.from_numpy(rng.standard_normal((3, 50)).astype(
                np.float32)),
             "b": torch.from_numpy((rng.standard_normal(70) * 1e3).astype(
                 np.float32))} for _ in range(W)]


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_psum_is_the_ordered_fold_and_the_fp32_ring_its_bits(W):
    trees = _workers(W, W)
    with C.collective_trace() as log:
        got = C.psum_flat_segments(iter(trees), name="t")
        ring = C.psum_flat_segments(trees, name="r", ring="fp32",
                                    ring_workers=W)
    for k in ("a", "b"):
        want = trees[0][k].clone()
        for t in trees[1:]:
            want = want + t[k]
        assert torch.equal(got[k], want) and torch.equal(ring[k], want)
    assert log[0] == {"name": "t", "bytes": 220 * 4, "kind": "all_reduce"}
    assert log[1]["kind"] == "ring" and log[1]["bytes"] == \
        C.ring_wire_bytes(220, W, "fp32")


def test_int8_ring_keeps_exempt_segments_exact_and_conserves_mass():
    W = 4
    trees = _workers(7, W)
    for t in trees:
        t["n"] = torch.ones(())
    with C.collective_trace() as log:
        merged, res = C.psum_flat_segments(trees, name="w", ring="int8",
                                           ring_workers=W,
                                           ring_exempt=("n", "b"))
    assert [r["name"] for r in log] == ["w", "w_exempt"]
    assert float(merged["n"]) == W
    want_b = trees[0]["b"].clone()
    for t in trees[1:]:
        want_b += t["b"]
    assert torch.equal(merged["b"], want_b)
    assert set(res) == {"a"} and res["a"].shape == (W, 3, 50)
    total = sum(t["a"].double() for t in trees)
    led = merged["a"].double() + res["a"].double().sum(0)
    scale = max(float(t["a"].abs().max()) for t in trees)
    assert float((led - total).abs().max()) <= 8 * W * scale * 2.0 ** -24


def test_traced_psum_and_csvec_merge():
    from repro_torch.countsketch.csvec import CSVec
    xs = [torch.full((2, 3), float(i)) for i in range(3)]
    with C.collective_trace() as log:
        assert torch.equal(C.traced_psum(xs, name="x"), torch.full((2, 3),
                                                                  3.0))
        cs = C.psum_csvec([CSVec(table=x, params=((1, 2, 3, 4),), dim=9)
                           for x in xs])
    assert torch.equal(cs.table, torch.full((2, 3), 3.0))
    assert [r["name"] for r in log] == ["x", "csvec_table"]
    assert all(r["bytes"] == 24 for r in log)


def test_ring_needs_its_worker_count():
    with pytest.raises(ValueError):
        C.psum_flat_segments(_workers(0, 2), ring="fp32")
    with pytest.raises(ValueError):
        C.psum_flat_segments(_workers(0, 2), ring="fp32", ring_workers=3)
    with pytest.raises(ValueError):
        C.psum_flat_segments(_workers(0, 2), ring="fp16", ring_workers=2)
