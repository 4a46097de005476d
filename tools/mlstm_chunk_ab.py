#!/usr/bin/env python3
"""Build one or more versions of the ``mlstm_chunk`` CUDA source and
compare them on the card: agreement with ``mlstm_chunk_plain`` and time
a call, at xlstm-1.3b's serving and refill shapes and two small ragged
ones.

    python3 tools/mlstm_chunk_ab.py [SRC ...]      # on a Hopper card

SRC defaults to ``src/repro_torch/csrc/mlstm_chunk.cu``. To compare
with another version, unpack its tree under ``artifacts/`` (git
archive) and pass both sources, which then run in the order A B B A in
each case. Each source is built with the package's nvcc flags into
``src/repro_torch/_build/ab/`` and bound in place of the package's
build, so the wrapper ``mlstm_chunk`` runs it. Prints the card's name
and power limit, each build's register and spill lines, then one JSON
line a case and run: the errors of h, C and n relative to max|plain|,
ms a call over 5 calls (CUDA events), the plain version's ms, and
``torch.profiler``'s µs a call of each kernel (null where the profiler
lost its markers).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import mlstm_chunk as MC  # noqa: E402

# B, H, S, Dk, Dv, chunk, input type
CASES = ((8, 4, 2048, 512, 1024, 256, torch.bfloat16),     # serving
         (1, 4, 512, 512, 1024, 256, torch.bfloat16),      # refill
         (8, 4, 2048, 512, 1024, 256, torch.float32),
         (2, 3, 96, 24, 70, 32, torch.float32),
         (2, 2, 40, 8, 16, 256, torch.bfloat16))
CALLS = 5


def build(i: int, src: Path) -> ctypes.CDLL:
    out = _build.BUILD_DIR / "ab" / f"libmlstm_chunk_{i}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    log = _build.compile_cu(src, out).splitlines()   # raises if it fails
    print(src, *(ln for ln in log if "Used" in ln or "spill" in ln),
          sep="\n", flush=True)
    lib = ctypes.CDLL(str(out))
    MC._bind(lib)
    return lib


def inputs(gen, B, H, S, Dk, Dv, dt):
    q, k = (torch.randn((B, H, S, Dk), generator=gen, device="cuda").to(dt)
            for _ in range(2))
    # v as the model passes it: a (B, H, S, Dv) view of (B, S, H, Dv)
    v = torch.randn((B, S, H, Dv), generator=gen, device="cuda").to(
        dt).transpose(1, 2)
    li = torch.randn((B, H, S), generator=gen, device="cuda") * 0.5
    lf = torch.nn.functional.logsigmoid(
        torch.randn((B, H, S), generator=gen, device="cuda") + 2)
    return q, k, v, li, lf


def ms_a_call(fn, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(calls):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / calls


def main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    srcs = [Path(a) for a in argv] or [_build.CSRC / "mlstm_chunk.cu"]
    libs = [build(i, src) for i, src in enumerate(srcs)]
    order = list(range(len(srcs))) + list(reversed(range(len(srcs))))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, H, S, Dk, Dv, chunk, dt in CASES:
        args = inputs(gen, B, H, S, Dk, Dv, dt)
        want = MC.mlstm_chunk_plain(*args, chunk=chunk)
        plain_ms = ms_a_call(lambda: MC.mlstm_chunk_plain(*args, chunk=chunk),
                             2)
        for i in order:
            _build._LIBS["mlstm_chunk"] = libs[i]

            def call():
                return MC.mlstm_chunk(*args, chunk=chunk)

            h, (C, n, _) = call()
            errs = [float((a - b).abs().max() / b.abs().max())
                    for a, b in zip((h, C, n), (want[0],) + want[1][:2])]
            split = chip_smoke._device_kernels(call, 2)
            print(json.dumps(dict(
                src=str(srcs[i]), shape=[B, H, S, Dk, Dv], chunk=chunk,
                dtype=str(dt).split(".")[-1], rel_err_h_C_n=errs,
                ms=ms_a_call(call, CALLS), plain_ms=plain_ms,
                kernel_us=split and {name: us / 2 for name, (_, us)
                                     in split.items()})), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
