"""The csvec_topk kernels on a CUDA device against their plain version:
indices and values exactly equal, ties included, on the pruned path
(odd r: seed sample, masks, refining and final pruned sweeps) and the
unpruned one (even r),
at a ragged dimension, on integer tables whose k-th magnitude ties, on a
flat table that passes every coordinate, and at c 2^20 (a coarse bit per
4 buckets, confirmed in the fine bitmap; a refining sweep); the
thresholds and the counts of coordinates that pass the row tests equal
the plain emulation's (``emulate_pruned``).

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


@pytest.mark.requires_cuda
@pytest.mark.parametrize("r,c,n,k,kind", CASES)
def test_cuda_topk_equals_plain_version(r, c, n, k, kind):
    table = _table(r, c, kind, seed=n + k)
    params = hash_params(torch.Generator().manual_seed(n), r)
    before = KT.csvec_topk.launches
    got = KT.csvec_topk(table, params, n, k)
    want = KT.csvec_topk_ref(table, params, n, k)
    torch.cuda.synchronize()
    assert KT.csvec_topk.launches == before + 1
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    plan = KT.prune_plan(r, c, n, k)
    assert (plan is None) == (r % 2 == 0)
    if plan is None:
        assert KT.prune_stats() is None
        return
    stats = KT.prune_stats()
    _, mirror = KT.emulate_pruned(table, params, n, k, plan)
    for key in ("tau0", "tau", "dense", "refine_survivors", "survivors"):
        assert stats[key] == mirror[key], key
    if kind == "flat":               # the unpruned sweep
        assert stats["dense"] and stats["survivors"] == n
    if kind == "ties":               # some coordinate ties tau and wins
        assert float(got[0].abs().min()) == stats["tau"]
