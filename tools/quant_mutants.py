#!/usr/bin/env python3
"""Check that chip_smoke.py's csvec_quant checks tell a fault in the
kernel: q exact, scale and dhat bit for bit with NaN in the same places,
resid within one ulp of the row's amax (``chip_smoke._quant_exact``).

    PYTHONPATH=src python3 tools/quant_mutants.py

Each mutant is ``csrc/csvec_quant.cu`` with one fault: the amax fold that
lets a later number replace a NaN (``a <= m ? m : a``, the fold before
the NaN repair); the clamp by fmaxf / fminf, which sends a NaN code to
-127; the last block of each row leaving its amax out of the row's word;
the scale as amax times fl(1/127) in place of amax / 127; dhat from the
float code in place of the int8 one (a -0 code gives -0); the last
partial load of each block's part skipped (a ragged tail left unwritten);
a block that goes on with the row's amax as soon as it has arrived
itself, before the row's other blocks (a handoff once half of them have
arrived is often harmless: the blocks arrive close together, so the amax
is mostly whole when it is read). Each is built by nvcc into a temporary directory (the
checkout is not touched) and loaded in place of the library; the
unedited source runs first as the control. The cases are the tables of
``chip_smoke.CS_CASES`` (the train geometry's table a random vector's
sketch) and the same with NaN, inf and -inf and a planted row amax whose
quotient and reciprocal product round apart
(``chip_smoke._quant_nonfinite``), in both forms; one JSON line a
(mutant, case, form) says whether the check fails and why. Exits 1 if
the control fails or a mutant passes every case. Needs a CUDA device and
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
    ("nan_replaced_in_the_fold", [
        ("csvec_quant.cu", "  return max(m, __float_as_uint(fabsf(x)));",
         "  const float a = fabsf(x), b = __uint_as_float(m);\n"
         "  return __float_as_uint(a <= b ? b : a);")]),
    ("fmaxf_clamp", [
        ("csvec_quant.cu",
         "  return v != v ? v : fminf(fmaxf(v, -127.f), 127.f);",
         "  return fminf(fmaxf(v, -127.f), 127.f);")]),
    ("drops_a_blocks_amax", [
        ("csvec_quant.cu", "        atomicMax(amax, m);",
         "        if (blockIdx.x % g.bpr != g.bpr - 1) atomicMax(amax, m);")]),
    ("reciprocal_scale", [
        ("csvec_quant.cu", "__fdiv_rn(__uint_as_float(bits), 127.f)",
         "__fmul_rn(__uint_as_float(bits), 1.f / 127.f)")]),
    ("dhat_from_the_float_code", [
        ("csvec_quant.cu", "dh[k] = __fmul_rn((float)code[k], scale);",
         "dh[k] = __fmul_rn(qf, scale);")]),
    ("skips_the_ragged_tail", [
        ("csvec_quant.cu",
         "        if (e < hi) emit<V, FULL>(g, row + e, v[u], scale, safe);",
         "        if (e + STEP <= hi) emit<V, FULL>(g, row + e, v[u], scale, "
         "safe);")]),
    ("hands_off_before_the_row_arrives", [
        ("csvec_quant.cu",
         "while (ld_acquire(arrived) < (unsigned)g.bpr)",
         "while (ld_acquire(arrived) < 1u)")]),
]


def tables(dev):
    """(label, table) of each case, as chip_smoke.py's phase 2 draws
    them."""
    import torch
    import chip_smoke
    from repro_torch.configs import get_arch
    from repro_torch.countsketch.csvec import hash_params
    from repro_torch.kernels.csvec_insert import csvec_insert
    from repro_torch.models.transformer import num_params
    for label, r, c, n, _ in chip_smoke.CS_CASES:
        n = n or num_params(get_arch("tinyllama-1.1b"))
        params = hash_params(torch.Generator().manual_seed(r * 31 + c % 97),
                             r)
        vec = torch.randn(n, generator=torch.Generator(device=dev)
                          .manual_seed(7), device=dev)
        table = csvec_insert(torch.zeros((r, c), device=dev), params, vec)
        del vec
        yield label, table
        yield f"{label}_nonfinite", chip_smoke._quant_nonfinite(table)


def main() -> int:
    import torch
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import chip_smoke
    from _mutate import build, loaded
    from repro_torch.kernels import csvec_quant as KQ

    dev = torch.device("cuda")
    cases = list(tables(dev))
    caught = {}
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(MUTANTS)) as pool:
            libs = dict(zip([m[0] for m in MUTANTS], pool.map(
                lambda m: build("csvec_quant", Path(tmp), m[1], m[0]),
                MUTANTS)))
        for name, lib_file in libs.items():
            KQ._PER_SM.clear()
            for words in KQ._WORDS.values():
                words.zero_()
            with loaded("csvec_quant", lib_file, KQ._bind):
                caught[name] = False
                for label, table in cases:
                    for dhat_only in (False, True):
                        why = None
                        try:
                            chip_smoke._quant_exact(label, table, dhat_only)
                        except AssertionError as e:
                            why = str(e)
                        caught[name] |= why is not None
                        print(json.dumps(dict(
                            mutant=name, case=label, dhat_only=dhat_only,
                            check_fails=why is not None, why=why)),
                            flush=True)
    ok = not caught["control"] and all(
        v for k, v in caught.items() if k != "control")
    print(json.dumps(dict(caught=caught, ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
