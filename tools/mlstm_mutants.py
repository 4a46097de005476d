#!/usr/bin/env python3
"""Check that the 1e-4 tolerance tells a fault in mlstm_chunk's
tensor-core kernels from rounding.

    PYTHONPATH=src python3 tools/mlstm_mutants.py

Each mutant is ``csrc/mlstm_chunk.cu`` and the headers it includes with
one fault: the lo half of the scores dropped from s v (s carried as
bf16(s) alone); C read after the chunk's update (each chunk's k pieces
moved before its q and s pieces, so that h sees the new C); the last
chunk's C update skipped. Each is built by nvcc into a temporary
directory (the checkout is not touched) and loaded in place of the
library; the unedited source runs first as the control. Every bf16 row
of ``chip_smoke.MLSTM_CASES`` that takes the tensor cores, and three
small tensor-core shapes, run against ``mlstm_chunk_plain``, and one
JSON line a (mutant, case) gives the largest share of the allowance
(h, C, n: rtol ``TOL``, atol ``TOL`` * max|plain|; m: ``TOL``) that any
output uses and whether chip_smoke.py's check fails (a NaN fails it).
Exits 1 if the control fails or a mutant passes every case. Needs a
CUDA device and nvcc.
"""
from __future__ import annotations

import concurrent.futures
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# (name, its edits: (file, the text, its replacement[, occurrence]))
MUTANTS = [
    ("control", []),
    ("drops_the_lo_half_of_s", [
        ("mlstm_chunk.cu",
         "            mma_rs_n64_k(P32, va[u], kmaj(slo, kt0 + 2 * u));\n",
         "")]),
    ("reads_c_after_the_update", [
        ("mlstm_chunk.cu", "const int c = p / P, i = p % P;",
         "const int c = p / P, i = (p % P + 2 * R) % P;", 0),
        ("mlstm_chunk.cu", "const int c = p / P, i = p % P;",
         "const int c = p / P, i = (p % P + 2 * R) % P;", 0)]),
    ("skips_the_last_update", [
        ("mlstm_chunk.cu", "    } else {\n      // C^T = decay C^T",
         "    } else if (c < nc - 1) {\n      // C^T = decay C^T")]),
]
# (label, B, H, S, Dk, Dv, chunk): small tensor-core shapes beside
# chip_smoke's
SMALL = [("w64", 1, 2, 256, 512, 128, 64), ("w128", 2, 3, 384, 512, 192, 128),
         ("one_chunk", 2, 1, 256, 512, 64, 256)]


def main() -> int:
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from _mutate import build, loaded
    from repro_torch.kernels import mlstm_chunk as MC

    cases = SMALL + [c for c in chip_smoke.MLSTM_CASES
                     if c[4] == MC.TC_DK and c[5] % 64 == 0
                     and min(c[6], c[3]) % 64 == 0]
    caught = {}
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(MUTANTS)) as pool:
            libs = dict(zip([m[0] for m in MUTANTS], pool.map(
                lambda m: build("mlstm_chunk", Path(tmp), m[1], m[0]),
                MUTANTS)))
        for name, lib_file in libs.items():
            with loaded("mlstm_chunk", lib_file, MC._bind):
                caught[name] = False
                gen = torch.Generator(device="cuda").manual_seed(5)
                for label, B, H, S, Dk, Dv, chunk in cases:
                    def rand(*shape):
                        return torch.randn(shape, generator=gen,
                                           device="cuda")
                    bf = torch.bfloat16
                    q, k = rand(B, H, S, Dk).to(bf), rand(B, H, S, Dk).to(bf)
                    v = rand(B, S, H, Dv).to(bf).transpose(1, 2)
                    li = rand(B, H, S) * 0.5
                    lf = torch.nn.functional.logsigmoid(rand(B, H, S) + 2.0)
                    assert MC.uses_tensor_cores(q, k, v, chunk)
                    got = MC.mlstm_chunk(q, k, v, li, lf, chunk=chunk)
                    want = MC.mlstm_chunk_plain(q, k, v, li, lf, chunk=chunk)
                    used = {}
                    for n, g, w in zip("hCnm", (got[0],) + got[1],
                                       (want[0],) + want[1]):
                        scale = 1.0 if n == "m" else float(w.abs().max())
                        used[n] = float(((g - w).abs() / (chip_smoke.TOL * (
                            scale + w.abs()))).nan_to_num(float("inf")).max())
                    fails = not max(used.values()) <= 1
                    caught[name] |= fails
                    print(json.dumps(dict(
                        mutant=name, case=label, shape=[B, H, S, Dk, Dv],
                        chunk=chunk, used=used, check_fails=fails)),
                        flush=True)
                    del q, k, v, got, want
                    torch.cuda.empty_cache()
    ok = not caught["control"] and all(
        v for k, v in caught.items() if k != "control")
    print(json.dumps(dict(caught=caught, ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
