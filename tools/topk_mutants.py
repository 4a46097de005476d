#!/usr/bin/env python3
"""Check that chip_smoke.py's csvec_topk checks tell a fault in the
pruned search: the exact result and the count of coordinates that pass
the row test, against the plain emulation ``emulate_pruned``.

    PYTHONPATH=src python3 tools/topk_mutants.py

Each mutant is ``csrc/csvec_topk.cu`` with one fault: the row test
needing one row fewer than (r + 1) / 2 (a superset: the result stays
exact, the counts of the refining and final sweeps do not), or one row
more (members dropped); the masks taking |table| > tau in place of >=
(a coordinate that ties tau is dropped, which the integer table with
ties at the k-th magnitude catches); the median network by fminf /
fmaxf, which drop a NaN; the order blind to NaN (a NaN estimate never
ranks above anything). Each is built by nvcc into a temporary directory
(the checkout is not touched) and loaded in place of the library, in a
process of its own; the unedited source runs first as the control. The cases are the odd-r rows
of ``chip_smoke.CS_CASES`` (the train geometry's table a random vector's
sketch), an integer table whose k-th magnitude ties, a flat one, and the
small odd-r table with each of ``chip_smoke.TOPK_NONFINITE`` put in; one
JSON line a (mutant, case, k) says whether the values (with NaN in the
same places), the indices and the counts equal the plain versions'. Exits 1
if the control fails or a mutant passes every case. Needs a CUDA device
and nvcc.
"""
from __future__ import annotations

import concurrent.futures
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# (name, its edits: (file, the text, its replacement))
MUTANTS = [
    ("control", []),
    ("needs_a_row_fewer", [
        ("csvec_topk.cu", "constexpr int NEED = (R + 1) / 2;",
         "constexpr int NEED = (R + 1) / 2 - 1;")]),
    ("needs_a_row_more", [
        ("csvec_topk.cu", "constexpr int NEED = (R + 1) / 2;",
         "constexpr int NEED = (R + 1) / 2 + 1;")]),
    ("strict_mask", [
        ("csvec_topk.cu", "fabsf(row[b]) >= tau", "fabsf(row[b]) > tau")]),
    ("nan_dropping_median", [
        ("csvec_topk.cu", "      e[j] = min_nan(a, c);\n"
         "      e[j + 1] = max_nan(a, c);",
         "      e[j] = fminf(a, c);\n      e[j + 1] = fmaxf(a, c);")]),
    ("nan_blind_order", [
        ("csvec_topk.cu", "  if (n1 || n2) return n1 && (!n2 || i1 < i2);\n",
         "")]),
]


def tables(dev):
    """(label, table, params, dim, ks) of each case."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.countsketch.csvec import hash_params
    from repro_torch.kernels.csvec_insert import csvec_insert
    from repro_torch.models.transformer import num_params
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    for label, r, c, n, ks in chip_smoke.CS_CASES:
        if r % 2 == 0:
            continue
        n = n or num_params(get_arch("tinyllama-1.1b"))
        params = hash_params(torch.Generator().manual_seed(r * 31 + c % 97),
                             r)
        vec = torch.randn(n, generator=torch.Generator(device=dev)
                          .manual_seed(7), device=dev)
        table = csvec_insert(torch.zeros((r, c), device=dev), params, vec)
        del vec
        yield label, table, params, n, ks
        if c == 128:
            for what in chip_smoke.TOPK_NONFINITE:
                yield (f"{label}_{what}", chip_smoke._put_nonfinite(
                    table, params, n, what), params, n, ks)
    gen = torch.Generator(device=dev).manual_seed(3)
    params = hash_params(torch.Generator().manual_seed(3), 5)
    yield ("ties", torch.randint(-4, 5, (5, 2**12), generator=gen,
                                 device=dev).float(), params, 65_537, (300,))
    yield "flat", torch.full((5, 2**10), 3.0, device=dev), params, 50_000, (
        256,)


def run(name: str, lib_file: str) -> None:
    """Every case against the library ``lib_file``, one JSON line each."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from _mutate import loaded
    from repro_torch.kernels import csvec_topk as KT

    dev = torch.device("cuda")
    with loaded("csvec_topk", Path(lib_file), KT._bind):
        for label, table, params, n, ks in tables(dev):
            for k in ks:
                wv, wi = KT.csvec_topk_ref(table, params, n, k)
                mirror = KT.emulate_pruned(
                    table, params, n, k, KT.prune_plan(*table.shape, n, k))[1]
                gv, gi = KT.csvec_topk(table, params, n, k)
                stats = KT.prune_stats()
                row = dict(
                    mutant=name, case=label, k=k,
                    values_equal=chip_smoke._same(gv, wv),
                    indices_equal=bool(torch.equal(gi, wi)),
                    counts=[stats["refine_survivors"], stats["survivors"]],
                    mirror_counts=[mirror["refine_survivors"],
                                   mirror["survivors"]])
                row["check_fails"] = not (
                    row["values_equal"] and row["indices_equal"]
                    and row["counts"] == row["mirror_counts"])
                print(json.dumps(row), flush=True)


def main(argv: list[str]) -> int:
    """Builds the mutants, then runs each in a process of its own (a
    mutant that faults on the card cannot take the others with it; a
    fault fails its check, as it would fail chip_smoke.py's)."""
    if argv[:1] == ["--run"]:
        run(*argv[1:3])
        return 0
    from _mutate import build
    caught = {}
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(MUTANTS)) as pool:
            libs = dict(zip([m[0] for m in MUTANTS], pool.map(
                lambda m: build("csvec_topk", Path(tmp), m[1], m[0]),
                MUTANTS)))
        for name, lib_file in libs.items():
            proc = subprocess.run(
                [sys.executable, __file__, "--run", name, str(lib_file)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            rows = [json.loads(line) for line in proc.stdout.splitlines()
                    if line.startswith("{")]
            for row in rows:
                print(json.dumps(row), flush=True)
            caught[name] = any(row["check_fails"] for row in rows)
            if proc.returncode:
                caught[name] = True
                print(json.dumps(dict(
                    mutant=name, check_fails=True, exit=proc.returncode,
                    error=proc.stderr.strip().splitlines()[-1:])),
                    flush=True)
    ok = not caught["control"] and all(
        v for k, v in caught.items() if k != "control")
    print(json.dumps(dict(caught=caught, ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
