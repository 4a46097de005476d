"""The port's ring all-reduce on the CPU against the JAX reference's
oracle ``ring_allreduce_ref``, jitted as ``tests/test_ring.py`` holds
the Pallas kernel to it (XLA:CPU contracts the oracle's arithmetic inside
its ``fori_loop``; the port follows the compiled arithmetic).

Inputs are ``tests/test_ring.py``'s: standard normal rows scaled by
10^U{-3..3} per worker, made with numpy and fed to both. Tolerance: none,
y and the residual rows must be equal bit for bit. The ledger
``dequant(y) + sum_d res_d == sum_d x_d`` is held to 8 W ulps of the
largest shard element (each hop leaves one rounding of the fold).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ring_allreduce import _chunk_len as jax_chunk_len
from repro.kernels.ring_allreduce import ring_allreduce_ref
from repro.kernels.ring_allreduce import ring_wire_bytes as jax_wire_bytes
from repro_torch.kernels import ring_allreduce as RA


def _shards(seed, W, N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((W, N))
            * 10.0 ** rng.integers(-3, 4, size=(W, 1))).astype(np.float32)


@pytest.mark.parametrize("wire", ["fp32", "int8"])
@pytest.mark.parametrize("W", [2, 3, 4, 8])
def test_plain_version_is_the_jitted_oracle_bitwise(W, wire):
    ref = jax.jit(lambda a: ring_allreduce_ref(a, wire_dtype=wire))
    for N in (3, 129, 1000):
        xs = _shards(W * 1000 + N, W, N)
        yr, rr = ref(jnp.asarray(xs))
        y, res = RA.ring_allreduce(torch.from_numpy(xs), wire)
        assert np.array_equal(y.numpy(), np.asarray(yr)), (W, N, wire)
        assert np.array_equal(res.numpy(), np.asarray(rr)), (W, N, wire)
        if wire == "fp32":
            fold = xs[0].copy()
            for d in range(1, W):
                fold = fold + xs[d]
            assert np.array_equal(y.numpy(), fold) and not res.any()


@pytest.mark.parametrize("wire", ["fp32", "int8"])
@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_plain_version_is_the_jitted_oracle_on_a_nonfinite_shard(kind, wire):
    """A NaN or an inf in one worker's row: y and the residual rows equal
    the jitted oracle's with NaN in the same places (on the int8 wire
    the chunk's amax and scale turn NaN or inf, so its whole chunk does
    from that fold point on)."""
    ref = jax.jit(lambda a: ring_allreduce_ref(a, wire_dtype=wire))
    for W in (2, 4):
        xs = _shards(W * 7 + 1000, W, 1000)
        xs[1, 17] = np.nan if kind == "nan" else np.inf
        yr, rr = (np.asarray(a) for a in ref(jnp.asarray(xs)))
        y, res = RA.ring_allreduce(torch.from_numpy(xs), wire)
        np.testing.assert_array_equal(y.numpy(), yr)   # NaN where NaN
        np.testing.assert_array_equal(res.numpy(), rr)
        assert not np.isfinite(y.numpy()[17])
        if wire == "int8":
            assert np.isnan(res.numpy()[1:, 17]).all()


@pytest.mark.parametrize("seed", range(4))
def test_int8_ledger_conserves_mass(seed):
    for W in (2, 4, 8):
        xs = _shards(seed * 31 + W, W, 777)
        y, res = RA.ring_allreduce(torch.from_numpy(xs), "int8")
        led = y.double() + res.double().sum(0)
        total = torch.from_numpy(xs).double().sum(0)
        tol = 8 * W * float(np.abs(xs).max()) * 2.0 ** -24
        assert float((led - total).abs().max()) <= tol
        assert res.any(), "the int8 wire left no residual"


def test_replicas_are_the_merged_vector():
    xs = torch.from_numpy(_shards(5, 4, 300))
    for wire in RA.WIRE_DTYPES:
        y, _ = RA.ring_allreduce(xs, wire)
        ys, _ = RA.ring_allreduce(xs, wire, replicas=True)
        assert ys.shape == (4, 300)
        assert all(torch.equal(ys[d], y) for d in range(4))


def test_one_worker_is_the_identity_and_launches_nothing():
    x = torch.arange(7.0)[None]
    before = RA.ring_allreduce.launches
    for wire in RA.WIRE_DTYPES:
        y, res = RA.ring_allreduce(x, wire)
        yr, rr = ring_allreduce_ref(jnp.asarray(x.numpy()), wire_dtype=wire)
        assert torch.equal(y, x[0]) and not res.any()
        assert np.array_equal(y.numpy(), np.asarray(yr))
        assert res.shape == np.asarray(rr).shape
    assert RA.ring_allreduce.launches == before


def test_unknown_wire_dtype_and_bad_shapes_raise():
    with pytest.raises(ValueError):
        RA.ring_allreduce(torch.zeros(2, 4), "fp16")
    with pytest.raises(ValueError):
        RA.ring_allreduce(torch.zeros(8), "fp32")
    with pytest.raises(ValueError):
        RA.ring_allreduce(torch.zeros(2, 4, dtype=torch.float64), "fp32")


def test_chunk_length_and_wire_bytes_are_the_references():
    for n in (1, 3, 128, 129, 1000, 10**6 + 3):
        for w in (1, 2, 3, 4, 8):
            assert RA._chunk_len(n, w) == jax_chunk_len(n, w)
            for wire in RA.WIRE_DTYPES:
                assert RA.ring_wire_bytes(n, w, wire) == \
                    jax_wire_bytes(n, w, wire)


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    """A tensor on another device than the CPU goes to the kernel
    wrapper's launch path (here: the meta device, which it refuses)."""
    called = []
    monkeypatch.setattr(RA, "ring_allreduce_plain",
                        lambda *a: called.append(a))
    with pytest.raises(ValueError, match="cpu or cuda"):
        RA.ring_allreduce(torch.zeros(2, 4, device="meta"), "fp32")
    assert not called


@pytest.mark.parametrize("W", [1, 2, 3, 8])
def test_kernels_per_call(W):
    """One fold on the fp32 wire; the level-0 amax and one launch a fold
    point on the int8 wire (chip_smoke.py holds a profiled call to it)."""
    assert RA.kernels_per_call(W, "fp32") == (W > 1)
    assert RA.kernels_per_call(W, "int8") == (W + 1 if W > 1 else 0)
