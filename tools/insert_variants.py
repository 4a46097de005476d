#!/usr/bin/env python3
"""Time csvec_insert's kernels, and variants of them, at the LM train
step's geometry (tinyllama-1.1b's 1,100,048,384-element gradient into a
5 x 2^23 table), each held to chip_smoke.py's 1e-4 check.

    PYTHONPATH=src python3 tools/insert_variants.py

Each variant is ``csrc/csvec_insert.cu`` with a few edits, built by nvcc
into a temporary directory (``tools/_mutate.py``; the checkout is not
touched) and loaded in place of the library; the unedited source runs
first. The variants are the choices the source's design note argues
for: ``csvec_insert_sum_bins`` at 512 threads with eight runs in flight
a warp, its shared float add written as ``red.shared.add.f32`` (printed:
the SASS atomics each build holds), ``csvec_insert_bin_records`` held to
three blocks an SM, tiles of 4096 elements.
Prints the card's name and power limit, then one JSON line a variant:
the device ms of a call (torch.profiler) and of each kernel, the share
of the allowance (rtol ``TOL``, atol ``TOL`` * max|plain|) its worst
counter uses, and the plan. Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

RED = ("csvec_insert.cu",
       "atomicAdd(acc + (at & (slice - 1u)), __uint_as_float(x.y));",
       'asm volatile("red.shared.add.f32 [%0], %1;" :: "r"((unsigned)'
       '__cvta_generic_to_shared(acc + (at & (slice - 1u)))), '
       '"f"(__uint_as_float(x.y)) : "memory");')
# (name, edits of csvec_insert.cu, elements a tile)
VARIANTS = [
    ("source", [], 8192),
    ("sum_512_threads_8_in_flight", [
        ("csvec_insert.cu", "constexpr int SUM_THREADS = 1024;",
         "constexpr int SUM_THREADS = 512;"),
        ("csvec_insert.cu", "constexpr int IN_FLIGHT = 4;",
         "constexpr int IN_FLIGHT = 8;")], 8192),
    ("red_shared_add", [RED], 8192),
    ("bin_records_3_blocks_an_sm", [
        ("csvec_insert.cu",
         "__launch_bounds__(BIN_THREADS)\n    csvec_insert_bin_records",
         "__launch_bounds__(BIN_THREADS, 3)\n    csvec_insert_bin_records")],
     8192),
    ("tiles_of_4096", [
        ("csvec_insert.cu", "constexpr int PER_THREAD = 16;",
         "constexpr int PER_THREAD = 8;")], 4096),
]


def launch(lib, out, params, vec, plan, tile: int) -> None:
    """``KI.launch`` for a build whose tiles hold ``tile`` elements: the
    table of runs has one word a (row, bin, tile)."""
    import torch
    from repro_torch.countsketch.csvec import _shift_for
    from repro_torch.kernels import csvec_insert as KI
    r, c = out.shape
    rec = torch.empty((r * plan.chunk * KI.RECORD_BYTES,),
                      dtype=torch.uint8, device=out.device)
    runs = torch.empty((r * plan.nbins * (plan.chunk // tile),),
                       dtype=torch.int32, device=out.device)
    err = lib.csvec_insert_launch(
        out.data_ptr(), vec.data_ptr(), vec.shape[0], r, c, _shift_for(c),
        KI.coeff_array(params), rec.data_ptr(), runs.data_ptr(),
        plan.bin_bits, plan.chunk, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"csvec_insert launch failed ({err})")


def main() -> int:
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from _mutate import build, loaded
    from repro_torch.configs import get_arch
    from repro_torch.countsketch.csvec import hash_params
    from repro_torch.kernels import _build
    from repro_torch.kernels import csvec_insert as KI
    from repro_torch.models.transformer import num_params

    print(chip_smoke.gpu_line(), flush=True)
    dev = torch.device("cuda")
    r, c = 5, 2**23
    n = num_params(get_arch("tinyllama-1.1b"))
    params = hash_params(torch.Generator().manual_seed(r * 31 + c % 97), r)
    vec = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(7),
                      device=dev)
    zeros = torch.zeros((r, c), device=dev)
    want = KI.csvec_insert_ref(zeros, params, vec)
    scale = float(want.abs().max())
    base = KI.insert_plan(n, r, c)
    with tempfile.TemporaryDirectory() as tmp:
        for name, edits, tile in VARIANTS:
            lib_file = build("csvec_insert", Path(tmp), edits, name)
            sass = subprocess.run(
                [str(Path(_build.nvcc()).parent / "cuobjdump"), "-sass",
                 str(lib_file)], capture_output=True, text=True).stdout
            atomics = collections.Counter(
                re.findall(r"\b(ATOMS\.[A-Z0-9.]+|REDS?\.[A-Z0-9.]+)", sass))
            chunk = -(-base.chunk // tile) * tile
            plan = dataclasses.replace(base, chunk=chunk,
                                       chunks=-(-n // chunk))
            with loaded("csvec_insert", lib_file, KI._bind) as lib:

                def call():
                    out = zeros.clone()
                    launch(lib, out, params, vec, plan, tile)
                    return out

                got = call()
                torch.cuda.synchronize()
                used = float(((got - want).abs() / (chip_smoke.TOL * (
                    scale + want.abs()))).nan_to_num(float("inf")).max())
                del got
                ms, call_ms = chip_smoke.time_ms(call, 3, 1)
                seen = chip_smoke._device_kernels(call, 1) or {}
            print(json.dumps(dict(
                variant=name, ms=ms, call_ms=call_ms, used=used,
                kernel_ms={k: sum(v[1] for key, v in seen.items()
                                  if k in key) / 1e3
                           for k in chip_smoke.INSERT_KERNELS},
                tile=tile, chunk=chunk, chunks=plan.chunks,
                bins=plan.nbins, shared_atomics=dict(atomics))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
