"""The csvec_insert kernels on a CUDA device against their plain
version, through the wrapper's own plan and through plans that reach
what the LM step's geometry leaves idle: many narrow bins, many chunks
with a ragged last one, bins wider than the 2**15-counter slice of
shared memory, c = 1, a hash that puts a whole tile in one bin.

Needs a CUDA device and nvcc: each test skips without one. This file
imports neither JAX nor the JAX package, so it runs where only the port
is installed:

    PYTHONPATH=src python -m pytest -q --noconftest \
        tests/test_torch_csvec_insert_cuda.py

Tolerance: rtol 1e-5, atol 1e-5 * max|plain| (as the CUDA case of
tests/test_torch_countsketch.py): the kernel sums each bucket in
shared-atomic order, the plain version in index order. The buckets and
signs are exact, so a misplaced record fails by the record's size.
"""
import numpy as np
import pytest
import torch

from repro_torch.countsketch.csvec import hash_params
from repro_torch.kernels import csvec_insert as KI


def _inputs(r, c, n, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(seed)
    params = hash_params(torch.Generator().manual_seed(seed), r)
    vec = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    table = torch.from_numpy(
        rng.standard_normal((r, c)).astype(np.float32)).cuda()
    return table, params, vec


def _close(got, want):
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("r,c,n", [(5, 128, 1000), (4, 2**12, 65_537),
                                   (1, 1, 50), (5, 2**16, 3_000_001),
                                   (8, 2**20, 100_003)])
def test_cuda_insert_matches_plain_version(r, c, n):
    table, params, vec = _inputs(r, c, n, n)
    before = KI.csvec_insert.launches
    got = KI.csvec_insert(table, params, vec)
    assert KI.csvec_insert.launches == before + 1
    _close(got, KI.csvec_insert_ref(table, params, vec))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("what", ["narrow", "chunks", "slices"])
def test_cuda_insert_under_other_plans(what):
    r, c, n = {"narrow": (5, 2**12, 65_537),
               "chunks": (3, 2**16, 5 * KI.TILE + 17),
               "slices": (2, 2**17, 200_001)}[what]
    table, params, vec = _inputs(r, c, n, 3)
    if what == "narrow":            # 256 bins of 16 counters a row
        plan = KI.InsertPlan(rows=r, bin_bits=4, nbins=c >> 4, chunk=KI.TILE,
                             chunks=-(-n // KI.TILE))
    elif what == "chunks":          # six chunks of a tile, 17 in the last
        plan = KI.InsertPlan(rows=r, bin_bits=15, nbins=2, chunk=KI.TILE,
                             chunks=6)
    else:                           # one bin of 2**17: four slices
        plan = KI.InsertPlan(rows=r, bin_bits=17, nbins=1,
                             chunk=-(-n // KI.TILE) * KI.TILE, chunks=1)
    got = table.clone()
    KI.launch(got, params, vec, plan)
    _close(got, KI.csvec_insert_ref(table, params, vec))


@pytest.mark.requires_cuda
def test_cuda_insert_with_a_skewed_hash_stays_right():
    # a_b = 1 puts consecutive indices in consecutive buckets, so a tile's
    # records fill one bin's run
    table, params, vec = _inputs(3, 2**16, 200_000, 5)
    params = ((1, 1, 1),) + tuple(params[1:])
    _close(KI.csvec_insert(table, params, vec),
           KI.csvec_insert_ref(table, params, vec))
