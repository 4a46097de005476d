#!/usr/bin/env python3
"""Check that chip_smoke.py's checks tell a fault in the csvec_insert and
ring_allreduce kernels from rounding.

    PYTHONPATH=src python3 tools/insert_ring_mutants.py

Each mutant is ``csrc/csvec_insert.cu`` or ``csrc/ring_allreduce.cu``
with one edit, built by nvcc into a temporary directory (the checkout is
not touched) and loaded in place of the library; the unedited sources
run first as the controls. The insert's mutants drop the ragged tail of
v (the last tile's elements when it is not whole), drop the last bin of
every row, and misplace a record's local bucket by one; each runs every
row of ``chip_smoke.CS_CASES`` against the plain version and prints one
JSON line a (mutant, case): the share of chip_smoke.py's allowance
(rtol ``TOL``, atol ``TOL`` * max|plain|) the worst counter uses, and
whether the check fails (a NaN fails it). The ring's mutant skips the
last fold point of the int8 wire; it runs the int8 cases of chip_smoke's
grid (W 2, 3, 4, 8 x N 3, 129, 1000, 2^20), where the check is equality
bit for bit of every replica and residual row, and prints the rows and
elements that differ. Exits 1 if a control fails or a mutant passes
every case. Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import concurrent.futures
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# (name, the kernel, its edits: (file, the text, its replacement))
MUTANTS = [
    ("insert_control", "csvec_insert", []),
    ("drops_the_ragged_tail", "csvec_insert", [
        ("csvec_insert.cu", "min(g.begin + g.len, g.n) - t0);",
         "(min(g.begin + g.len, g.n) - t0) / TILE * TILE);")]),
    ("drops_the_last_bin", "csvec_insert", [
        ("csvec_insert.cu", "csvec_insert_sum_bins<<<dim3(nbins, rows)",
         "csvec_insert_sum_bins<<<dim3(nbins - (nbins > 1), rows)")]),
    ("misplaces_the_local_bucket", "csvec_insert", [
        ("csvec_insert.cu", "atomicAdd(acc + (at & (slice - 1u))",
         "atomicAdd(acc + ((at + 1u) & (slice - 1u))")]),
    ("ring_control", "ring_allreduce", []),
    ("skips_the_last_int8_level", "ring_allreduce", [
        ("ring_allreduce.cu", "for (int d = 0; d < workers; ++d) {",
         "for (int d = 0; d < workers - 1; ++d) {")]),
]


def insert_cases(dev):
    """Each CS_CASES row's table, coefficients, vector and plain sum, as
    chip_smoke.py's phase 2 draws them."""
    import torch
    import chip_smoke
    from repro_torch.configs import get_arch
    from repro_torch.countsketch.csvec import hash_params
    from repro_torch.kernels.csvec_insert import csvec_insert_ref
    from repro_torch.models.transformer import num_params
    for label, r, c, n, _ in chip_smoke.CS_CASES:
        n = n or num_params(get_arch("tinyllama-1.1b"))
        params = hash_params(torch.Generator().manual_seed(r * 31 + c % 97),
                             r)
        vec = torch.randn(n, generator=torch.Generator(
            device=dev).manual_seed(7), device=dev)
        zeros = torch.zeros((r, c), device=dev)
        yield (label, r, c, n), (zeros, params, vec,
                                 csvec_insert_ref(zeros, params, vec))


def run_insert(name, cases) -> bool:
    import torch
    import chip_smoke
    from repro_torch.kernels.csvec_insert import csvec_insert
    caught = False
    for (label, r, c, n), (zeros, params, vec, want) in cases:
        got = csvec_insert(zeros, params, vec)
        torch.cuda.synchronize()
        used = float(((got - want).abs() / (chip_smoke.TOL * (
            want.abs().max() + want.abs()))).nan_to_num(float("inf")).max())
        fails = not used <= 1
        caught |= fails
        print(json.dumps(dict(mutant=name, case=label, r=r, c=c, n=n,
                              used=used, check_fails=fails)), flush=True)
    return caught


def run_ring(name, dev) -> bool:
    import torch
    import chip_smoke
    from repro_torch.kernels.ring_allreduce import (
        ring_allreduce, ring_allreduce_plain,
    )
    caught = False
    for W in chip_smoke.RING_WORKERS:
        for N in chip_smoke.RING_SIZES:
            xs = chip_smoke._ring_shards(dev, W, N, W * 7 + N)
            want_y, want_res = ring_allreduce_plain(xs.cpu(), "int8")
            y, res = ring_allreduce(xs, "int8", replicas=True)
            y, res = y.cpu(), res.cpu()
            rows = [d for d in range(W) if not torch.equal(y[d], want_y)]
            res_rows = [d for d in range(W)
                        if not torch.equal(res[d], want_res[d])]
            differ = int((y != want_y).sum() + (res != want_res).sum())
            fails = bool(rows or res_rows)
            caught |= fails
            print(json.dumps(dict(mutant=name, W=W, N=N,
                                  replicas_differ=rows,
                                  residual_rows_differ=res_rows,
                                  elements_differ=differ,
                                  check_fails=fails)), flush=True)
    return caught


def main() -> int:
    import torch
    sys.path.insert(0, str(ROOT))
    from _mutate import build, loaded
    from repro_torch.kernels import csvec_insert as KI
    from repro_torch.kernels import ring_allreduce as RA

    dev = torch.device("cuda")
    binders = {"csvec_insert": KI._bind, "ring_allreduce": RA._bind}
    caught = {}
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(MUTANTS)) as pool:
            libs = list(pool.map(
                lambda m: build(m[1], Path(tmp), m[2], m[0]), MUTANTS))
        cases = list(insert_cases(dev))
        for (name, kernel, _), lib_file in zip(MUTANTS, libs):
            with loaded(kernel, lib_file, binders[kernel]):
                caught[name] = (run_insert(name, cases)
                                if kernel == "csvec_insert"
                                else run_ring(name, dev))
    ok = all(v != name.endswith("control") for name, v in caught.items())
    print(json.dumps(dict(caught=caught, ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
