"""The csvec_topk kernels on a CUDA device against their plain version:
indices and values exactly equal, ties included, on the pruned path
(odd r: seed sample, masks, refining and final pruned sweeps) and the
unpruned one (even r),
at a ragged dimension, on integer tables whose k-th magnitude ties, on a
flat table that passes every coordinate, and at c 2^20 (a coarse bit per
4 buckets, confirmed in the fine bitmap; a refining sweep); the
thresholds and the counts of coordinates that pass the row tests equal
the plain emulation's (``emulate_pruned``). Then the same tables with a
NaN in a bucket of the seed sample, a NaN only where no sample
coordinate reaches, a whole NaN row (as the int8 quantiser makes it) or
an inf, at odd r (pruned: a NaN switches to the unpruned sweep), even r
and on the flat table: the values equal with NaN in the same places,
the NaN estimates first.

Needs a CUDA device and nvcc: each test skips without one. This file
imports neither JAX nor the JAX package, so it runs where only the port
is installed:

    PYTHONPATH=src python -m pytest -q --noconftest \
        tests/test_torch_csvec_topk_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.countsketch.csvec import hash_params
from repro_torch.kernels import csvec_topk as KT

CASES = [  # (r, c, dim, k, table)
    (5, 128, 1000, 64, "normal"),          # ragged: k - 1 past a tile
    (3, 128, 997, 100, "normal"),
    (5, 2**12, 65_537, 300, "ties"),       # integers: ties at tau0
    (3, 2**10, 40_000, 512, "ties"),
    (4, 128, 1000, 64, "normal"),          # even r: unpruned
    (4, 2**12, 65_537, 64, "ties"),
    (5, 2**10, 50_000, 256, "flat"),       # every coordinate passes
    (1, 2**10, 50_000, 16, "normal"),
    # a coarse bit per 4 buckets; a refining sweep of dim / 16
    (5, 2**20, 100_000_007, 256, "normal"),
]
NONFINITE = ("nan_in_sample", "nan_outside", "nan_row", "inf")
NONFINITE_CASES = [  # (r, c, dim, k, table, what is put in it)
    *[(5, 2**12, 65_537, 300, "normal", x) for x in NONFINITE],
    *[(4, 2**12, 65_537, 64, "normal", x) for x in NONFINITE],
    *[(5, 2**10, 50_000, 256, "flat", x) for x in NONFINITE],
    (5, 128, 1000, 64, "normal", "nan_outside"),
    (5, 2**20, 100_000_007, 256, "normal", "nan_outside"),
    (5, 2**20, 100_000_007, 256, "normal", "inf"),
]


def _table(r, c, kind, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(seed)
    if kind == "ties":
        t = rng.integers(-4, 5, (r, c))
    elif kind == "flat":
        t = np.full((r, c), 3.0)
    else:
        t = rng.standard_normal((r, c)) * rng.pareto(2.0, (r, c))
    return torch.from_numpy(t.astype(np.float32)).cuda()


def put_nonfinite(table, params, dim, what):
    """``table`` with a NaN in a bucket of the seed sample's (hash row
    2), a NaN in a bucket that no sample coordinate reaches and some
    other one does, a whole NaN row as the int8 quantiser makes it from
    one NaN entry, or an inf in a sample bucket; the sample is the
    pruned path's (``prune_plan``'s, the same at even r)."""
    from repro_torch.countsketch.csvec import (
        dequantize_table, hash_buckets, quantize_table,
    )
    r, c = table.shape
    sample = min(KT.SAMPLE, dim // 4)
    seed = torch.arange(sample, device=table.device) * (dim // sample)
    bk = hash_buckets(params, c, seed)
    t = table.clone()
    if what == "nan_in_sample":
        t[2, bk[2, 0]] = float("nan")
    elif what == "nan_outside":
        reach = hash_buckets(params, c, torch.arange(
            min(dim, 1 << 22), device=table.device))
        for j in range(r):
            free = torch.ones(c, dtype=torch.bool, device=table.device)
            free[bk[j]] = False
            hit = torch.zeros_like(free)
            hit[reach[j]] = True
            left = torch.nonzero(free & hit)
            if left.numel():
                t[j, int(left[0])] = float("nan")
                break
        assert bool(torch.isnan(t).any())
    elif what == "nan_row":
        t[2, 17] = float("nan")
        t = dequantize_table(*quantize_table(t))
        assert bool(torch.isnan(t[2]).all())
    else:
        t[2, bk[2, 0]] = float("inf")
    return t


def same(got, want) -> bool:
    """Equal, with NaN in the same places (``torch.equal`` holds a NaN
    unequal to itself); for the stats' numbers, a NaN equals a NaN."""
    if not isinstance(want, torch.Tensor):
        return got == want or (got != got and want != want)
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan],
                                                              want[~nan])


def _check(table, params, r, c, n, k):
    before = KT.csvec_topk.launches
    got = KT.csvec_topk(table, params, n, k)
    want = KT.csvec_topk_ref(table, params, n, k)
    torch.cuda.synchronize()
    assert KT.csvec_topk.launches == before + 1
    assert torch.equal(got[1], want[1]) and same(got[0], want[0])
    plan = KT.prune_plan(r, c, n, k)
    assert (plan is None) == (r % 2 == 0)
    if plan is None:
        assert KT.prune_stats() is None
        return got, None
    stats = KT.prune_stats()
    _, mirror = KT.emulate_pruned(table, params, n, k, plan)
    for key in ("tau0", "tau", "dense", "nonfinite", "refine_survivors",
                "survivors"):
        assert same(stats[key], mirror[key]), key
    return got, stats


@pytest.mark.requires_cuda
@pytest.mark.parametrize("r,c,n,k,kind", CASES)
def test_cuda_topk_equals_plain_version(r, c, n, k, kind):
    table = _table(r, c, kind, seed=n + k)
    params = hash_params(torch.Generator().manual_seed(n), r)
    got, stats = _check(table, params, r, c, n, k)
    if stats is None:
        return
    assert not stats["nonfinite"]
    if kind == "flat":               # the unpruned sweep
        assert stats["dense"] and stats["survivors"] == n
    if kind == "ties":               # some coordinate ties tau and wins
        assert float(got[0].abs().min()) == stats["tau"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("r,c,n,k,kind,what", NONFINITE_CASES)
def test_cuda_topk_on_a_nonfinite_table_equals_plain_version(r, c, n, k,
                                                            kind, what):
    params = hash_params(torch.Generator().manual_seed(n), r)
    table = put_nonfinite(_table(r, c, kind, seed=n + k), params, n, what)
    got, stats = _check(table, params, r, c, n, k)
    if what != "inf":                 # the NaN estimates rank first
        nan = torch.isnan(got[0])
        assert bool(nan[0]) and not bool((~nan[:-1] & nan[1:]).any())
    if stats is not None and what != "inf":
        assert stats["nonfinite"] and stats["survivors"] == n
