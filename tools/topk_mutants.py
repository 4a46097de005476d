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
ties at the k-th magnitude catches). Each is built by nvcc into a
temporary directory (the checkout is not touched) and loaded in place of
the library; the unedited source runs first as the control. The cases
are the odd-r rows of ``chip_smoke.CS_CASES`` (the train geometry's
table a random vector's sketch), an integer table whose k-th magnitude
ties and a flat one; one JSON line a (mutant, case, k) says whether the
values, the indices and the counts equal the plain versions'. Exits 1
if the control fails or a mutant passes every case. Needs a CUDA device
and nvcc.
"""
from __future__ import annotations

import concurrent.futures
import json
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
        yield label, csvec_insert(torch.zeros((r, c), device=dev), params,
                                  vec), params, n, ks
        del vec
    gen = torch.Generator(device=dev).manual_seed(3)
    params = hash_params(torch.Generator().manual_seed(3), 5)
    yield ("ties", torch.randint(-4, 5, (5, 2**12), generator=gen,
                                 device=dev).float(), params, 65_537, (300,))
    yield "flat", torch.full((5, 2**10), 3.0, device=dev), params, 50_000, (
        256,)


def main() -> int:
    import torch
    sys.path.insert(0, str(ROOT))
    from _mutate import build, loaded
    from repro_torch.kernels import csvec_topk as KT

    dev = torch.device("cuda")
    cases = list(tables(dev))
    # the plain versions once: the exact result and the emulated count
    want = {}
    for label, table, params, n, ks in cases:
        for k in ks:
            want[label, k] = (KT.csvec_topk_ref(table, params, n, k),
                              KT.emulate_pruned(table, params, n, k,
                                                KT.prune_plan(*table.shape,
                                                              n, k))[1])
    caught = {}
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(MUTANTS)) as pool:
            libs = dict(zip([m[0] for m in MUTANTS], pool.map(
                lambda m: build("csvec_topk", Path(tmp), m[1], m[0]),
                MUTANTS)))
        for name, lib_file in libs.items():
            with loaded("csvec_topk", lib_file, KT._bind):
                caught[name] = False
                for label, table, params, n, ks in cases:
                    for k in ks:
                        (wv, wi), mirror = want[label, k]
                        gv, gi = KT.csvec_topk(table, params, n, k)
                        stats = KT.prune_stats()
                        row = dict(
                            mutant=name, case=label, k=k,
                            values_equal=bool(torch.equal(gv, wv)),
                            indices_equal=bool(torch.equal(gi, wi)),
                            counts=[stats["refine_survivors"],
                                    stats["survivors"]],
                            mirror_counts=[mirror["refine_survivors"],
                                           mirror["survivors"]])
                        row["check_fails"] = not (
                            row["values_equal"] and row["indices_equal"]
                            and row["counts"] == row["mirror_counts"])
                        caught[name] |= row["check_fails"]
                        print(json.dumps(row), flush=True)
    ok = not caught["control"] and all(
        v for k, v in caught.items() if k != "control")
    print(json.dumps(dict(caught=caught, ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
