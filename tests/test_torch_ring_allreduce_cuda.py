"""The ring_allreduce kernels on a CUDA device against their plain
version: W 2, 3, 4 and 8 workers, N from below one 128-lane chunk to a
million elements (not multiples of 4, of the lane or of W, so the
kernel's unaligned edges run), both wire dtypes, inputs of a wide
dynamic range as ``tests/test_ring.py`` draws them.

Needs a CUDA device and nvcc: each test skips without one. This file
imports neither JAX nor the JAX package, so it runs where only the port
is installed:

    PYTHONPATH=src python -m pytest -q --noconftest \
        tests/test_torch_ring_allreduce_cuda.py

Tolerance: none. The kernel's arithmetic is the plain version's step for
step (IEEE adds, divisions and FMAs as intrinsics, the chunk's amax exact),
so y, every replica and every residual row must equal the plain
version's bit for bit, computed on the CPU from the same inputs; with a
NaN or an inf in one worker's row, with NaN in the same places.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ring_allreduce as RA

WORKERS = (2, 3, 4, 8)
SIZES = (3, 129, 1000, 1_048_573)


def _shards(seed, W, N):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(seed)
    xs = (rng.standard_normal((W, N))
          * 10.0 ** rng.integers(-3, 4, size=(W, 1))).astype(np.float32)
    return torch.from_numpy(xs)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("wire", RA.WIRE_DTYPES)
@pytest.mark.parametrize("W", WORKERS)
def test_cuda_kernel_matches_plain_version_bitwise(W, wire):
    for N in SIZES:
        xs = _shards(W * 7 + N, W, N)
        want_y, want_res = RA.ring_allreduce_plain(xs, wire)
        before = RA.ring_allreduce.launches
        y, res = RA.ring_allreduce(xs.cuda(), wire, replicas=True)
        torch.cuda.synchronize()
        assert RA.ring_allreduce.launches == before + 1
        y, res = y.cpu(), res.cpu()
        for d in range(W):
            assert torch.equal(y[d], want_y), (W, N, wire, d)
        assert torch.equal(res, want_res), (W, N, wire)
        y0, res0 = RA.ring_allreduce(xs.cuda(), wire)
        assert torch.equal(y0.cpu(), want_y) and torch.equal(res0.cpu(),
                                                             want_res)
        if wire == "int8":
            # the ledger: dequant(y) + sum_d res_d == sum_d x_d, to ulp
            # scale of the largest shard
            total = xs.double().sum(0)
            led = want_y.double() + want_res.double().sum(0)
            tol = 8 * W * float(xs.abs().max()) * 2.0 ** -24
            assert float((led - total).abs().max()) <= tol


@pytest.mark.requires_cuda
def test_cuda_w1_launches_nothing():
    xs = _shards(0, 1, 100)
    before = RA.ring_allreduce.launches
    y, res = RA.ring_allreduce(xs.cuda(), "int8")
    assert RA.ring_allreduce.launches == before
    assert torch.equal(y.cpu(), xs[0]) and not res.any()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("wire", RA.WIRE_DTYPES)
def test_cuda_kernel_takes_a_view_off_16_byte_alignment(wire):
    # rows of 1024 elements, so the kernel takes its 16-byte path, on a
    # base 4 bytes past an aligned one
    W, N = 4, 1024
    xs = _shards(5, W, N)
    flat = torch.zeros(W * N + 1, device="cuda")
    flat[1:] = xs.reshape(-1).cuda()
    view = flat[1:].view(W, N)
    assert view.data_ptr() % 16
    want_y, want_res = RA.ring_allreduce_plain(xs, wire)
    y, res = RA.ring_allreduce(view, wire, replicas=True)
    torch.cuda.synchronize()
    for d in range(W):
        assert torch.equal(y[d].cpu(), want_y), (wire, d)
    assert torch.equal(res.cpu(), want_res)


@pytest.mark.requires_cuda
def test_cuda_int8_zero_chunks_and_a_zero_worker():
    # chunk 0 zero on every worker (scale 0, divisor 1), worker 1 all
    # zero (a fold point that only requantises), a ragged last chunk
    W, N = 4, 1000
    xs = _shards(9, W, N)
    S = RA._chunk_len(N, W)
    xs[:, :S] = 0
    xs[1] = 0
    want_y, want_res = RA.ring_allreduce_plain(xs, "int8")
    for replicas in (False, True):
        y, res = RA.ring_allreduce(xs.cuda(), "int8", replicas=replicas)
        torch.cuda.synchronize()
        for row in (y.reshape(-1, N) if replicas else y[None]):
            assert torch.equal(row.cpu(), want_y), replicas
        assert torch.equal(res.cpu(), want_res), replicas


def _equal(got, want):
    """``torch.equal`` (as the other cases), with NaN in the same
    places."""
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan],
                                                              want[~nan])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("wire", RA.WIRE_DTYPES)
@pytest.mark.parametrize("kind", ["nan", "inf"])
@pytest.mark.parametrize("W", [2, 4])
def test_cuda_kernel_on_a_nonfinite_shard(W, kind, wire):
    # one worker's row holds a NaN or an inf (in chunk 0 and in the
    # ragged last chunk): on the int8 wire the chunk's amax and scale
    # turn NaN or inf from that fold point on
    N = 1000
    xs = _shards(W * 11 + N, W, N)
    bad = float("nan") if kind == "nan" else float("inf")
    xs[1, 17] = bad
    xs[W - 1, N - 1] = bad
    want_y, want_res = RA.ring_allreduce_plain(xs, wire)
    y, res = RA.ring_allreduce(xs.cuda(), wire, replicas=True)
    torch.cuda.synchronize()
    for d in range(W):
        assert _equal(y[d].cpu(), want_y), (W, kind, wire, d)
    assert _equal(res.cpu(), want_res), (W, kind, wire)
    assert not bool(torch.isfinite(want_y[[17, N - 1]]).any())
