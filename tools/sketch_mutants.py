#!/usr/bin/env python3
"""Check that chip_smoke.py's 1e-4 tolerance tells a fault in the
tensor-core sketch_update kernel, or in its stacked launch, from
rounding.

    PYTHONPATH=src python3 tools/sketch_mutants.py

Each mutant is ``csrc/sketch_update.cu`` and the headers it includes
with one edit: the lo part of each projection dropped from the products
(so P is carried as bf16(P) alone), the last T split dropped from the
ordered sum of the splits, and three faults of the stacked launch (one
launch over E experts' triples): every expert writing expert 0's
outputs, the last expert's blocks not launched, psi read from expert 0.
Each is built by nvcc into a temporary directory (the checkout is not
touched) and loaded in place of the library; the unedited sources run
first as the control. Each runs every bf16 row of
``chip_smoke.SKETCH_UPDATE_CASES`` and every row of
``chip_smoke.STACKED_CASES`` against the plain version and prints one
JSON line a (mutant, case): the largest share of the allowance (rtol
``TOL``, atol ``TOL`` * max|plain|) any output uses, and whether
chip_smoke.py's check fails (a NaN fails it, and so does a launch the
card refuses, which chip_smoke.py raises on). Exits 1 if the control
fails or a mutant passes every case. Needs a CUDA device and nvcc.
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
    ("every_expert_writes_expert_0", [
        ("ema_update.cuh", "  o.out += e * 3 * dk;\n", "")]),
    ("skips_the_last_expert", [
        ("sketch_update.cu", "splits,\n                  experts);",
         "splits,\n                  experts - 1);"),
        ("ema_update.cuh", "FMA_TILE_D, splits, experts);",
         "FMA_TILE_D, splits, experts - 1);")]),
    ("reads_psi_of_expert_0", [
        ("ema_update.cuh", "  o.psi += (size_t)e * o.k;\n", "")]),
]


def main() -> int:
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from _mutate import build, loaded
    from repro_torch.kernels import _build
    from repro_torch.kernels import sketch_update as S

    # (label, experts or None, T, d, k, dtype)
    cases = [(c[0], None) + tuple(c[1:])
             for c in chip_smoke.SKETCH_UPDATE_CASES
             if S.uses_tensor_cores(c[1], c[2], getattr(torch, c[4]))]
    cases += [c[:6] for c in chip_smoke.STACKED_CASES]
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
                for label, E, T, d, k, dt in cases:
                    rand = lambda *s: torch.randn(
                        s, generator=gen, device="cuda")
                    lead = (E,) if E else ()
                    args = (rand(*lead, T, d).to(getattr(torch, dt)),
                            rand(*lead, d, k), rand(*lead, d, k),
                            rand(*lead, d, k), rand(T, k), rand(T, k),
                            rand(T, k), rand(*lead, k))
                    want = S.sketch_update_ref(*args, 0.9)
                    try:
                        got = S.sketch_update(*args, beta=0.9)
                        used = max(float(((g - w).abs() / (
                            chip_smoke.TOL * (w.abs().max() + w.abs())))
                            .nan_to_num(float("inf")).max())
                            for g, w in zip(got, want))
                    except RuntimeError:  # a refused launch fails too
                        used = float("inf")
                    fails = not used <= 1
                    caught[name] |= fails
                    tc = S.uses_tensor_cores(T, d, getattr(torch, dt))
                    print(json.dumps(dict(
                        mutant=name, case=label, experts=E, T=T, d=d, k=k,
                        splits=S.launch_plan(T, d, sms, tc, E or 1)[0],
                        used=used, check_fails=fails)), flush=True)
    ok = not caught["control"] and all(
        v for k, v in caught.items() if k != "control")
    print(json.dumps(dict(caught=caught, ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
