#!/usr/bin/env python3
"""A quick check of the csvec_topk and mlstm_chunk kernels on the card:
build both sources (printing each kernel's registers and spills), run
their card test files, then time csvec_topk at the LM train step's
geometry (tinyllama-1.1b's 1,100,048,384 coordinates, a 5 x 2^23 table
sketching a random vector, k 256 and 512; then a flat table) and
mlstm_chunk (bf16) at xlstm-1.3b's serving and refill shapes.

    PYTHONPATH=src python3 tools/topk_mlstm_check.py

Prints the card's name and power limit, then one JSON line a case: for
the top-k whether it equals ``csvec_topk_ref``, ``prune_stats``, the
device and call ms (``chip_smoke.time_ms``) and each kernel's device µs
(torch.profiler); for mlstm_chunk the errors of h, C and n relative to
max|plain|, the ms and each kernel's µs a call. Needs a CUDA device and
nvcc.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def short(name: str) -> str:
    """A kernel's name without its namespace and argument list."""
    name = name.replace("(anonymous namespace)", "")
    return (re.search(r"(\w+)[<(]", name) or [None, name])[1]


def main() -> int:
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.configs import get_arch
    from repro_torch.countsketch.csvec import hash_params
    from repro_torch.kernels import _build
    from repro_torch.kernels import csvec_topk as KT
    from repro_torch.kernels import mlstm_chunk as MC
    from repro_torch.kernels.csvec_insert import csvec_insert
    from repro_torch.models.transformer import num_params

    print(chip_smoke.gpu_line(), flush=True)
    for name in ("mlstm_chunk", "csvec_topk"):
        print(*(ln for ln in _build.build(name).splitlines()
                if "Used" in ln or "spill" in ln), sep="\n", flush=True)
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "--noconftest", "-p",
         "no:cacheprovider", "tests/test_torch_mlstm_chunk_cuda.py",
         "tests/test_torch_csvec_topk_cuda.py"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True)
    print(tests.stdout.strip().splitlines()[-1], flush=True)
    rc = tests.returncode

    dev = torch.device("cuda")
    r, c = 5, 2**23
    n = num_params(get_arch("tinyllama-1.1b"))
    params = hash_params(torch.Generator().manual_seed(r * 31 + c % 97), r)
    vec = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(7),
                      device=dev)
    tables = {"random": csvec_insert(torch.zeros((r, c), device=dev), params,
                                     vec),
              "flat": torch.full((r, c), 3.0, device=dev)}
    del vec
    for label, table in tables.items():
        for k in (256, 512) if label == "random" else (256,):
            def call():
                return KT.csvec_topk(table, params, n, k)

            got = call()
            stats = KT.prune_stats()
            equal = all(bool(torch.equal(g, w)) for g, w in
                        zip(got, KT.csvec_topk_ref(table, params, n, k)))
            rc |= not equal
            ms, call_ms = chip_smoke.time_ms(call, 5, 1)
            seen = chip_smoke._device_kernels(call, 1) or {}
            print(json.dumps(dict(
                kernel="csvec_topk", table=label, k=k, equal=equal, ms=ms,
                call_ms=call_ms, prune=stats,
                kernel_us={short(key): [cnt, us] for key, (cnt, us)
                           in seen.items()})), flush=True)
    del tables
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(0)
    for B, H, S, Dk, Dv, chunk in ((8, 4, 2048, 512, 1024, 256),
                                   (1, 4, 512, 512, 1024, 256)):
        q, k = (torch.randn((B, H, S, Dk), generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        v = torch.randn((B, S, H, Dv), generator=gen, device=dev).bfloat16(
        ).transpose(1, 2)
        li = torch.randn((B, H, S), generator=gen, device=dev) * 0.5
        lf = torch.nn.functional.logsigmoid(
            torch.randn((B, H, S), generator=gen, device=dev) + 2)
        args = (q, k, v, li, lf)

        def call():
            return MC.mlstm_chunk(*args, chunk=chunk)

        h, (C, nn, _) = call()
        want = MC.mlstm_chunk_plain(*args, chunk=chunk)
        errs = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip((h, C, nn), (want[0],) + want[1][:2])]
        ms, call_ms = chip_smoke.time_ms(call, 10, 2)
        seen = chip_smoke._device_kernels(call, 3) or {}
        print(json.dumps(dict(
            kernel="mlstm_chunk", shape=[B, H, S, Dk, Dv], chunk=chunk,
            tensor_cores=MC.uses_tensor_cores(q, k, v, chunk),
            rel_err_h_C_n=errs, ms=ms, call_ms=call_ms,
            kernel_us={short(key): us / 3 for key, (_, us)
                       in seen.items()})), flush=True)
        del args, q, k, v, h, C, nn, want
        torch.cuda.empty_cache()
    return 1 if rc else 0


if __name__ == "__main__":
    sys.exit(main())
