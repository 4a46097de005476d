"""Count-sketch heavy-hitter search: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/csvec_topk.py::csvec_topk``.
The kernel is ``csrc/csvec_topk.cu`` (CUDA C++ for ``sm_90a``), built at
first use by ``kernels._build`` and called through ``ctypes``. It
returns the k coordinates of the sketched vector first by (|median-of-r
estimate| descending, index ascending), with their signed estimates,
never forming the (dim,) estimate vector.

Bound on an H100 SXM: the table is read once, 4 r c bytes: at the LM
train step's geometry (r = 5, c = 2^23) 168 MB, 0.050 ms at 3.35 TB/s;
the estimates' f32 work (sign products, the median network, the absolute
value: 26 operations a coordinate at r = 5) takes 0.43 ms at 67 TFLOP/s
and sets the bound. An estimate of every coordinate would need r * dim
= 5.5e9 gathers at random buckets of a table three times the L2, up to
176 GB of 32-byte sectors, 52.5 ms. Blocks sweep ranges of coordinates
and keep block-local top-k lists in shared memory, folded by bitonic
sorts; one block merges the lists (the source file has the details).

For odd r the sweep is pruned (``prune_plan``): the k-th best |estimate|
of a strided sample is a threshold tau0 at or below the k-th best of
all, a coordinate can reach |estimate| >= tau only if (r + 1) / 2 of
its rows hold |table| >= tau, and bitmaps of those buckets (a coarse
one in shared memory, a fine one in L2) test the rows before any gather.
A pruned sweep of the first dim / 16 coordinates then gives a tighter
threshold, max(tau0, their k-th best), for the sweep of all. Where half
the buckets or more hold |table| >= tau0 (a flat table), the search
skips both pruned sweeps for the unpruned one, decided on the card; so
it does where the table holds a NaN or the thresholds are not finite
(``nonfinite``). ``emulate_pruned`` is that search in plain PyTorch,
step by step.

Given the same table, the kernel's indices and values equal the plain
version's exactly, ties included, NaN and inf too: a NaN estimate ranks
first, as the plain version's stable descending sort puts it. ``csvec_topk`` takes the plain version
for CPU tensors and only for them; for CUDA tensors it launches the
kernels or raises. ``csvec_topk.launches`` counts the calls that
launched on the card; each enqueues two kernels, or on the pruned path
six (nine with the refining sweep), whose thresholds and counts
``csvec_topk.last`` keeps on the card for the last call
(``prune_stats`` reads them).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from repro_torch.countsketch.csvec import (
    PLAIN_CHUNK, CSVec, _shift_for, hash_buckets, query, select_topk,
    topk_streaming,
)
from repro_torch.kernels import _build
from repro_torch.kernels.csvec_insert import (
    check_params, check_table, coeff_array,
)

Tensor = torch.Tensor

MAX_K = 1024               # largest k the shared-memory buffers take
THREADS = 256              # threads a block (csrc THREADS)
BLOCKS_PER_SM = 4          # pass-1 blocks
MIN_PER_BLOCK = 64 * THREADS
PRUNE_THREADS = 1024       # threads of a pruned pass-1 block (csrc)
SAMPLE = 1 << 22           # coordinates of the pruned path's seed sample
MASK_BYTES = 160 * 1024    # the coarse bitmap, in shared memory


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def csvec_topk_ref(table: Tensor, params, dim: int, k: int,
                   chunk: int = PLAIN_CHUNK) -> tuple[Tensor, Tensor]:
    """The plain version: ``countsketch.csvec.topk_streaming``, (vals
    (k,) f32, idx (k,) int64) for k = min(k, dim)."""
    return topk_streaming(CSVec(table=table, params=params, dim=dim), k,
                          chunk)


def launch_plan(dim: int, k: int, sms: int) -> tuple[int, int, int, int]:
    """(kp, nb, blocks, per_block): the best-list length (k rounded up to
    a power of two), the shared buffer's entries, the pass-1 blocks and
    the coordinates each sweeps."""
    kp = _pow2(k)
    nb = _pow2(kp + 2 * THREADS)
    blocks = max(1, min(BLOCKS_PER_SM * sms, -(-dim // MIN_PER_BLOCK)))
    per_block = -(-dim // blocks)
    return kp, nb, blocks, per_block


@dataclasses.dataclass(frozen=True)
class PrunePlan:
    """The pruned path's shape: the seed sample (coordinates p * stride,
    p < sample), the refining sweep's first ``refine`` coordinates (0:
    none) and the coarse bitmap's bit per 2^gshift buckets."""

    sample: int
    stride: int
    refine: int
    gshift: int


def prune_plan(r: int, c: int, dim: int, k: int) -> PrunePlan | None:
    """The pruned path's plan, or None where the unpruned sweep runs:
    even r (the midpoint of two values below tau0 can round up to it) or
    a sample, min(SAMPLE, dim // 4) coordinates, holding fewer than k.
    The refining sweep takes dim // 16 coordinates where they outnumber
    the sample (only then can their k-th best beat tau0); the coarse
    bitmap r * c / 2^gshift bits within MASK_BYTES."""
    sample = min(SAMPLE, dim // 4)
    if r % 2 == 0 or sample < k:
        return None
    gshift = 0
    while r * -(-(c >> gshift) // 32) * 4 > MASK_BYTES:
        gshift += 1
    refine = dim // 16 if dim // 16 > sample else 0
    return PrunePlan(sample=sample, stride=dim // sample, refine=refine,
                     gshift=gshift)


def _row_test(table: Tensor, params, fine: Tensor, coarse: Tensor,
              gshift: int, idx: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """The kernel's row test of coordinates ``idx``: the rows' coarse
    bits in turn, stopped once the rows left cannot reach (r + 1) / 2;
    then, where a coarse bit stands for several buckets, the fine bits
    of the rows whose coarse bit is set, stopped once decided. Returns
    (passed (n,) bool, coarse bits tested (n,), fine bits looked up
    (n,))."""
    r = table.shape[0]
    need = (r + 1) // 2
    buckets = hash_buckets(params, table.shape[1], idx)
    miss = torch.zeros(idx.shape[0], dtype=torch.int64, device=idx.device)
    coarse_tests = torch.zeros_like(miss)
    sets = []
    for j in range(r):
        live = r - miss >= need
        hit = coarse[j, buckets[j] >> gshift]
        sets.append(live & hit)
        miss += (live & ~hit).long()
        coarse_tests += live.long()
    if gshift == 0:
        return sum(x.long() for x in sets) >= need, coarse_tests, \
            torch.zeros_like(miss)
    hits = torch.zeros_like(miss)
    fine_tests = torch.zeros_like(miss)
    left = sum(x.long() for x in sets)      # set rows not yet looked up
    for j in range(r):
        live = sets[j] & (hits < need) & (hits + left >= need)
        hits += (live & fine[j, buckets[j]]).long()
        fine_tests += live.long()
        left -= sets[j].long()
    return hits >= need, coarse_tests, fine_tests


def dense(fine: Tensor) -> bool:
    """The pruned path's switch to the unpruned sweep: half the buckets
    or more at or above tau0 (``fine``, the masks at tau0)."""
    return 2 * int(fine.sum()) >= fine.numel()


def _pruned_sweep(cs: CSVec, k: int, tau: float, gshift: int, n: int,
                  chunk: int):
    """The masks at ``tau``, the row test of coordinates [0, n) and the
    exact top k of those that pass (fewer where fewer pass): ((vals,
    idx), survivors, (coarse bits tested, fine bits looked up))."""
    table, dev = cs.table, cs.table.device
    fine = table.abs() >= tau
    coarse = fine.reshape(table.shape[0], -1, 1 << gshift).any(-1)
    bv = torch.zeros(0, dtype=torch.float32, device=dev)
    bi = torch.zeros(0, dtype=torch.int64, device=dev)
    survivors = coarse_tests = fine_tests = 0
    for a in range(0, n, chunk):
        idx = torch.arange(a, min(a + chunk, n), device=dev)
        passed, ct, ft = _row_test(table, cs.params, fine, coarse, gshift,
                                   idx)
        survivors += int(passed.sum())
        coarse_tests += int(ct.sum())
        fine_tests += int(ft.sum())
        idx = idx[passed]
        allv = torch.cat([bv, query(cs, idx)])
        alli = torch.cat([bi, idx])
        pos = select_topk(allv.abs(), k)
        bv, bi = allv[pos], alli[pos]
    return (bv, bi), survivors, (coarse_tests, fine_tests)


def emulate_pruned(table: Tensor, params, dim: int, k: int,
                   plan: PrunePlan, chunk: int = PLAIN_CHUNK):
    """The pruned search in plain PyTorch, as the kernels take it: tau0 =
    |the k-th best estimate| of the sample (ties to the smaller index);
    where the table is ``dense`` at tau0, holds a NaN or tau0 is not
    finite, the unpruned search; else, where the plan refines, the
    pruned sweep of [0, refine) at tau0 and tau = max(tau0, |its k-th
    best|) (tau0 where fewer than k pass), and the unpruned search where
    tau is not finite; then the fine masks |table| >= tau and the coarse
    ones (their OR over 2^gshift buckets), the row test of every
    coordinate, and the exact top k of those that pass. Returns ((vals,
    idx), stats) with stats tau0, tau, dense, nonfinite (the switch for
    a NaN or a threshold that is not finite), refine_survivors,
    survivors (coordinates that passed the last row test; dim where the
    unpruned search ran) and the coarse bits it tested and fine bits it
    looked up."""
    k = min(k, dim)
    cs = CSVec(table=table, params=params, dim=dim)
    seed = torch.arange(plan.sample, device=table.device) * plan.stride
    est = query(cs, seed)
    tau0 = tau = float(est[select_topk(est.abs(), k)[-1]].abs())
    stats = dict(tau0=tau0, tau=tau0, dense=dense(table.abs() >= tau0),
                 nonfinite=bool(torch.isnan(table).any())
                 or not math.isfinite(tau0),
                 refine_survivors=0, survivors=dim, coarse_tests=0,
                 fine_tests=0)
    if stats["dense"] or stats["nonfinite"]:
        return topk_streaming(cs, k, chunk), stats
    if plan.refine:
        (rv, _), stats["refine_survivors"], _ = _pruned_sweep(
            cs, k, tau0, plan.gshift, plan.refine, chunk)
        if rv.shape[0] == k:
            tau = max(tau0, float(rv[-1].abs()))
    stats.update(tau=tau, nonfinite=not math.isfinite(tau))
    if stats["nonfinite"]:
        return topk_streaming(cs, k, chunk), stats
    best, stats["survivors"], (stats["coarse_tests"], stats["fine_tests"]) \
        = _pruned_sweep(cs, k, tau, plan.gshift, dim, chunk)
    return best, stats


def prune_stats() -> dict | None:
    """The last CUDA call's pruned-path numbers, read from the card (a
    synchronisation): the thresholds tau0 and tau, whether the table was
    dense, whether it held a NaN or a threshold was not finite
    (``nonfinite``), the coordinates that passed the refining sweep's
    row test and the last one's (survivors, dim where the unpruned sweep
    ran, and their share of dim), and the plan; None if that call took
    the unpruned sweep or no call was made."""
    last = csvec_topk.last
    if last is None:
        return None
    plan, tau_val, counters, k, dim, buckets = last
    # tau_val[2 k - 1] stays 0 where the refining sweep gave no k-th
    tau0, tau1 = (abs(float(x)) for x in tau_val[[k - 1, 2 * k - 1]])
    refined, n, bits, _, nans = counters.tolist()
    return dict(tau0=tau0, tau=max(tau0, tau1), dense=2 * bits >= buckets,
                nonfinite=nans > 0 or not (math.isfinite(tau0)
                                           and math.isfinite(tau1)),
                refine_survivors=refined, survivors=n, pass_rate=n / dim,
                sample=plan.sample, stride=plan.stride, refine=plan.refine,
                group=1 << plan.gshift)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.csvec_topk_launch.argtypes = [p, i, i, i, p, ll, i, i, i, i, ll,
                                      p, p, p, p, p, ll, ll, i, ll, ll, i,
                                      ll, i, i, ll, i, p, p, p, p, p, p]
    lib.csvec_topk_launch.restype = i
    lib.csvec_topk_error_string.argtypes = [i]
    lib.csvec_topk_error_string.restype = ctypes.c_char_p


def csvec_topk(table: Tensor, params, dim: int,
               k: int) -> tuple[Tensor, Tensor]:
    """(vals (k,) f32, idx (k,) int64) of the top k = min(k, dim)
    coordinates of the vector sketched in ``table`` (r, c) f32 with
    ``params`` (4 rows of r uint32 host integers). CPU tensors take
    ``csvec_topk_ref``; CUDA tensors launch the kernels."""
    r, c = check_table(table)
    check_params(params, r)
    if not 1 <= dim < 2**31:
        raise ValueError(f"dim={dim} outside 1..2**31-1")
    k = min(int(k), dim)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside the kernel's range 1..{MAX_K}")
    if table.device.type == "cpu":
        return csvec_topk_ref(table, params, dim, k)
    if table.device.type != "cuda":
        raise ValueError(f"csvec_topk runs on cpu or cuda, not "
                         f"{table.device}")
    lib = _build.load("csvec_topk", _bind)
    dev = table.device
    sms = _build.num_sms(dev)
    kp, nb, blocks, per_block = launch_plan(dim, k, sms)
    plan = prune_plan(r, c, dim, k)
    rows = blocks
    # the pruned path's seed sample, its pruned sweeps (one block an SM:
    # the coarse bitmap fills shared memory) and their buffers
    s_blocks = s_per = r_blocks = r_per = p_blocks = p_per = p_nb = 0
    if plan is not None:
        _, _, s_blocks, s_per = launch_plan(plan.sample, k, sms)

        def sweep(n):
            nblk = max(1, min(sms, -(-n // MIN_PER_BLOCK)))
            return nblk, -(-n // nblk)

        r_blocks, r_per = sweep(plan.refine) if plan.refine else (0, 0)
        p_blocks, p_per = sweep(dim)
        p_nb = _pow2(kp + 2 * PRUNE_THREADS)
        rows = max(s_blocks, r_blocks, blocks, p_blocks)
    s_mag = torch.empty((rows, kp), dtype=torch.float32, device=dev)
    s_val = torch.empty((rows, kp), dtype=torch.float32, device=dev)
    s_idx = torch.empty((rows, kp), dtype=torch.int32, device=dev)
    vals = torch.empty((k,), dtype=torch.float32, device=dev)
    idx = torch.empty((k,), dtype=torch.int64, device=dev)
    coeffs = coeff_array(params)
    fine = coarse = tau_val = tau_idx = counters = None
    if plan is not None:
        fine = torch.empty((r * -(-c // 32),), dtype=torch.int32, device=dev)
        coarse = torch.empty((r * -(-(c >> plan.gshift) // 32),),
                             dtype=torch.int32, device=dev)
        tau_val = torch.zeros((2 * k,), dtype=torch.float32, device=dev)
        tau_idx = torch.empty((2 * k,), dtype=torch.int64, device=dev)
        # the two sweeps' survivors, the masks' set bits, the lists that
        # the last pass 2 reads, the table's NaN entries
        counters = torch.zeros((5,), dtype=torch.int64, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.csvec_topk_launch(
            table.data_ptr(), r, c, _shift_for(c), coeffs, dim, k, kp, nb,
            blocks, per_block, s_mag.data_ptr(), s_val.data_ptr(),
            s_idx.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            plan.sample if plan else 0, plan.stride if plan else 0,
            s_blocks, s_per, plan.refine if plan else 0, r_blocks, r_per,
            plan.gshift if plan else 0, p_blocks, p_per, p_nb, ptr(fine),
            ptr(coarse), ptr(tau_val), ptr(tau_idx), ptr(counters),
            stream)
    if err:
        raise RuntimeError(
            f"csvec_topk kernel launch failed: "
            f"{lib.csvec_topk_error_string(err).decode()} ({err})")
    csvec_topk.launches += 1
    csvec_topk.last = plan and (plan, tau_val, counters, k, dim, r * c)
    return vals, idx


csvec_topk.launches = 0
csvec_topk.last = None
