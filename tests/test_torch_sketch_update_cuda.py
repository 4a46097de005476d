"""The EMA update kernels (sketch_update, psparse_update) on a CUDA device
against their plain versions: the tensor-core kernels (bf16 A, d % 8 ==
0) and the FMA kernels (f32 A, or bf16 A with d % 8 != 0) at every tile
edge (T across the 64-row stages, d across the 128- and 32-column tiles,
k across the 64-output warpgroups), at a split of every count the plan
can choose (T rows, or psparse's 3m support slots), and two calls on
the same inputs equal bit for bit (the splits are summed in a fixed
order). tests/test_torch_psparse_update.py holds psparse's kernels on
the card too, where JAX is installed beside the card.

Needs a CUDA device and nvcc: each test skips without one. This file
imports neither JAX nor the JAX package, so it runs where only the port
is installed:

    PYTHONPATH=src python -m pytest -q --noconftest \\
        tests/test_torch_sketch_update_cuda.py

Tolerance: rtol 1e-4, atol 1e-4 * max|plain|, as ``chip_smoke.py``
holds the kernels (the sums run in another order, and the tensor-core
kernel carries each f32 projection as two bf16 parts, to about 2^-17 of
its size).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import psparse_update as P
from repro_torch.kernels import sketch_update as S

TOL = 1e-4
BETA = 0.9

# (T, d, k, dtype): every tile edge of both kernels. T within one stage,
# at a decode step's 8, and over several; d 3 and 50 (the FMA kernel in
# both types), 136 (a tensor-core tile whose second 64-column box lies
# past d), 1000 (a partial second box) and 5632 (whole tiles); k of one,
# two and three 64-output warpgroups
EDGES = [(T, d, k, dt)
         for T in (1, 8, 37, 300)
         for d in (3, 50, 136, 1000, 5632)
         for k in (1, 17, 33, 64)
         for dt in (torch.float32, torch.bfloat16)]


def _inputs(T, d, k, dtype, seed=0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).cuda()
    return [f(T, d).to(dtype), f(d, k), f(d, k), f(d, k), f(T, k), f(T, k),
            f(T, k), f(k)]


def _device_inputs(T, d, k, dtype, seed):
    """The same inputs drawn on the card (long T: no host copy)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f = lambda *s: torch.randn(s, generator=gen, device="cuda")
    return [f(T, d).to(dtype), f(d, k), f(d, k), f(d, k), f(T, k), f(T, k),
            f(T, k), f(k)]


def _check(args):
    before = S.sketch_update.launches
    got = S.sketch_update(*args, beta=BETA)
    again = S.sketch_update(*args, beta=BETA)
    torch.cuda.synchronize()
    assert S.sketch_update.launches == before + 2
    want = S.sketch_update_ref(*args, BETA)
    for g, h, w in zip(got, again, want):
        torch.testing.assert_close(g, w, rtol=TOL,
                                   atol=TOL * float(w.abs().max()))
        assert torch.equal(g, h), "two calls differ"


@pytest.mark.requires_cuda
@pytest.mark.parametrize("T,d,k,dtype", EDGES)
def test_tile_edges_match_plain_version(T, d, k, dtype):
    _check(_inputs(T, d, k, dtype, seed=T + d + k))


def _split_counts(rows_of, d, tc, sms, sizes):
    """{splits: the smallest of ``sizes`` whose plan takes that many}:
    every count the plan chooses over those sizes."""
    seen = {}
    for size in sizes:
        seen.setdefault(S.launch_plan(rows_of(size), d, sms, tc)[0], size)
    assert len(seen) > 1
    return seen


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tc", [True, False], ids=["tensor_cores", "fma"])
def test_every_split_count_the_plan_chooses(tc):
    """d 128 (one tensor-core tile, four FMA tiles), T up to past the
    plan's largest count: each count held to the plain version; a call
    enqueues a second kernel iff it splits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    d, dtype = 128, torch.bfloat16 if tc else torch.float32
    lo = S.FMA_MAX_T + 1 if tc else 1
    counts = _split_counts(lambda t: t, d, tc, sms,
                           range(lo, 4 * sms * S.TC_ROWS, 3))
    for splits, T in sorted(counts.items()):
        assert S.uses_tensor_cores(T, d, dtype) == tc
        before = S.sketch_update.kernel_launches
        _check(_device_inputs(T, d, 17, dtype, seed=splits))
        assert S.sketch_update.kernel_launches - before == \
            2 * (1 if splits == 1 else 2)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("which", [0, 4], ids=["a", "ups"])
def test_misaligned_input_raises(which):
    """The tensor-core kernel reads A and the projections in 16-byte
    chunks."""
    args = _inputs(65, 128, 9, torch.bfloat16)
    t = args[which]
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
    args[which] = flat[1:].view(t.shape)
    with pytest.raises(ValueError, match="aligned"):
        S.sketch_update(*args, beta=BETA)


def _psparse_inputs(T, d, k, dtype, density, seed):
    args = _device_inputs(T, d, k, dtype, seed)
    coeffs = P.psparse_hash_params(torch.Generator().manual_seed(seed))
    return (args[:4], coeffs, args[7], P.psparse_dim(T, k, density))


def _psparse_check(args, coeffs, psi, m):
    before = P.psparse_update.launches
    got = P.psparse_update(*args, coeffs, psi, beta=BETA, m=m)
    again = P.psparse_update(*args, coeffs, psi, beta=BETA, m=m)
    torch.cuda.synchronize()
    assert P.psparse_update.launches == before + 2
    want = P.psparse_update_ref(*args, coeffs, psi, beta=BETA, m=m)
    for g, h, w in zip(got, again, want):
        torch.testing.assert_close(g, w, rtol=TOL,
                                   atol=TOL * float(w.abs().max()))
        assert torch.equal(g, h), "two calls differ"


@pytest.mark.requires_cuda
@pytest.mark.parametrize("T,d,k,dtype", [
    (T, d, k, dt) for T in (8, 300, 1024) for d in (50, 136, 1000)
    for k in (1, 17, 64) for dt in (torch.float32, torch.bfloat16)])
def test_psparse_tile_edges_match_plain_version(T, d, k, dtype):
    _psparse_check(*_psparse_inputs(T, d, k, dtype, 0.1, seed=T + d + k))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rows,T,d,dtype", [
    (4, 2048, 50, torch.float32), (4, 2048, 5632, torch.float32),
    (1, 2048, 1000, torch.bfloat16), (300, 1024, 136, torch.bfloat16),
    (700, 1024, 1000, torch.float32)])
def test_psparse_carry_rows_match_plain_version(rows, T, d, dtype):
    """An A of fewer rows than the binding (a carry's B against the
    tree's token rows): only the ``live_slots`` are summed, on the FMA
    kernel, split where there are many; with no live slot the call is
    the decay alone, beta S exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    args = _device_inputs(rows, d, 9, dtype, seed=rows + d)[:4]
    psi = torch.randn(9, device="cuda")
    m = P.psparse_dim(T, 9, 0.1)
    gen = torch.Generator().manual_seed(rows)
    coeffs = P.psparse_hash_params(gen)
    while not all(bool((P.psparse_rows(c, m, T) < rows).any())
                  for c in coeffs):
        coeffs = P.psparse_hash_params(gen)
    got = P.psparse_update(*args, coeffs, psi, beta=BETA, m=m, num_tokens=T)
    again = P.psparse_update(*args, coeffs, psi, beta=BETA, m=m,
                             num_tokens=T)
    want = P.psparse_update_ref(*args, coeffs, psi, beta=BETA, m=m,
                                num_tokens=T)
    for g, h, w in zip(got, again, want):
        torch.testing.assert_close(g, w, rtol=TOL,
                                   atol=TOL * float(w.abs().max()))
        assert torch.equal(g, h), "two calls differ"
    if rows > 4:   # some slot is live for nearly every draw
        return
    while bool(torch.cat([P.psparse_rows(c, m, T) for c in coeffs]).lt(
            rows).any()):
        coeffs = P.psparse_hash_params(gen)
    got = P.psparse_update(*args, coeffs, psi, beta=BETA, m=m, num_tokens=T)
    for g, s in zip(got, args[1:]):
        assert torch.equal(g, BETA * s)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tc", [True, False], ids=["tensor_cores", "fma"])
def test_psparse_every_slot_split_count(tc):
    """d 128, density 1 (m = T > 64 on the tensor cores): each split
    count of the 3m slots the plan chooses."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    d, dtype = 128, torch.bfloat16 if tc else torch.float32
    lo = S.FMA_MAX_T + 1 if tc else 1
    counts = _split_counts(lambda m: 3 * m, d, tc, sms,
                           range(lo, 2 * sms * S.TC_ROWS, 3))
    for splits, m in sorted(counts.items()):
        before = P.psparse_update.kernel_launches
        _psparse_check(*_psparse_inputs(m, d, 9, dtype, 1.0, seed=splits))
        assert P.psparse_update.kernel_launches - before == \
            2 * (1 if splits == 1 else 2)
