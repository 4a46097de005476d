#!/usr/bin/env python3
"""Check that chip_smoke.py's 1e-4 tolerance tells a fault in the
tensor-core sketch_update kernel from rounding.

    PYTHONPATH=src python3 tools/sketch_mutants.py

Each mutant is ``csrc/sketch_update.cu`` and the headers it includes
with one edit: the lo part of each projection dropped from the products
(so P is carried as bf16(P) alone), or the last T split dropped from the
ordered sum of the splits. Each is built by nvcc into a temporary
directory (the checkout is not touched) and loaded in place of the
library; the unedited sources run first as the control. Each runs every
bf16 row of ``chip_smoke.SKETCH_UPDATE_CASES`` against the plain version
and prints one JSON line a (mutant, case): the largest share of the
allowance (rtol ``TOL``, atol ``TOL`` * max|plain|) any output uses, and
whether chip_smoke.py's check fails (a NaN fails it). Exits 1 if the
control fails or a mutant passes every case. Needs a CUDA device and
nvcc.
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
    ("drops_the_lo_product", [
        ("sketch_update.cu",
         "      mma_m64n128k16_rs(acc, lo[kk], b);\n", "")]),
    ("drops_the_last_split", [
        ("ema_update.cuh",
         "sp0 + q < splits ? o.ws[(sp0 + q) * 3 * dk + i] : 0.f;",
         "sp0 + q < splits - 1 ? o.ws[(sp0 + q) * 3 * dk + i] : 0.f;")]),
]


def main() -> int:
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from _mutate import build, loaded
    from repro_torch.kernels import _build
    from repro_torch.kernels import sketch_update as S

    cases = [c for c in chip_smoke.SKETCH_UPDATE_CASES
             if S.uses_tensor_cores(c[1], c[2], getattr(torch, c[4]))]
    sms = _build.num_sms(torch.device("cuda"))
    caught = {}
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(MUTANTS)) as pool:
            libs = dict(zip([m[0] for m in MUTANTS], pool.map(
                lambda m: build("sketch_update", Path(tmp), m[1], m[0]),
                MUTANTS)))
        for name, lib_file in libs.items():
            with loaded("sketch_update", lib_file, S._bind):
                caught[name] = False
                gen = torch.Generator(device="cuda").manual_seed(1)
                for label, T, d, k, _ in cases:
                    rand = lambda *s: torch.randn(
                        s, generator=gen, device="cuda")
                    args = (rand(T, d).to(torch.bfloat16), rand(d, k),
                            rand(d, k), rand(d, k), rand(T, k), rand(T, k),
                            rand(T, k), rand(k))
                    got = S.sketch_update(*args, beta=0.9)
                    want = S.sketch_update_ref(*args, 0.9)
                    used = max(float(((g - w).abs() / (chip_smoke.TOL * (
                        w.abs().max() + w.abs()))).nan_to_num(float("inf"))
                        .max()) for g, w in zip(got, want))
                    fails = not used <= 1
                    caught[name] |= fails
                    print(json.dumps(dict(
                        mutant=name, case=label, T=T, d=d, k=k,
                        splits=S.launch_plan(T, d, sms, True)[0], used=used,
                        check_fails=fails)), flush=True)
    ok = not caught["control"] and all(
        v for k, v in caught.items() if k != "control")
    print(json.dumps(dict(caught=caught, ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
