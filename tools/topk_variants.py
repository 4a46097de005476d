#!/usr/bin/env python3
"""Time csvec_topk's pruned search, and variants of it, at the LM train
step's geometry (tinyllama-1.1b's 1,100,048,384 coordinates, a 5 x 2^23
table, k 256), on the sketch of a random vector and on a flat table.

    PYTHONPATH=src python3 tools/topk_variants.py

Each variant is ``csrc/csvec_topk.cu`` with a few edits, built by nvcc
into a temporary directory (``tools/_mutate.py``; the checkout is not
touched) and loaded in place of the library; the unedited source runs
first. The variants are the choices the source's design note argues
for: two or eight coordinates a thread in place of four, 512 threads a
pruned block, a coordinate's fine lookups all sent at once (no stop
once decided), (timing only: more coordinates pass, so its result
is not checked) no fine bitmap lookups, the pruned block's launch
bounds without their one block an SM, and the order and median network
blind to NaN, as they were before the NaN repair. Prints the card's name and power
limit, each build's registers, stack and spills a kernel (``cuobjdump
-res-usage``), then one JSON line a (variant, table): whether the result
equals the plain version's (null where not checked), the device ms of a
call and of each kernel (torch.profiler), and the pruned path's numbers
(``prune_stats``). Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# (name, edits of csvec_topk.cu, whether its result is checked)
VARIANTS = [
    ("source", [], True),
    ("two_a_thread", [
        ("csvec_topk.cu", "constexpr int PER = 4;", "constexpr int PER = 2;")],
     True),
    ("eight_a_thread", [
        ("csvec_topk.cu", "constexpr int PER = 4;", "constexpr int PER = 8;")],
     True),
    ("512_threads", [
        ("csvec_topk.cu", "constexpr int PRUNE_THREADS = 1024;",
         "constexpr int PRUNE_THREADS = 512;")], True),
    ("fine_lookups_at_once", [
        ("csvec_topk.cu",
         "          live[u] = R - miss[u] >= NEED && ((set[u] >> j) & 1u) &&\n"
         "                    hits[u] < NEED && hits[u] + __popc(set[u] >> j) "
         ">= NEED;",
         "          live[u] = R - miss[u] >= NEED && ((set[u] >> j) & 1u);")],
     True),
    ("no_fine_lookups", [
        ("csvec_topk.cu",
         "          word[u] = live[u] ? __ldg(fine + (size_t)j * nfw + "
         "(bk[u] >> 5))\n                            : 0u;",
         "          word[u] = 0xffffffffu;")], False),
    # the pruned block's launch bounds without their one block an SM
    ("no_min_blocks", [
        ("csvec_topk.cu", "__launch_bounds__(PRUNE_THREADS, 1)",
         "__launch_bounds__(PRUNE_THREADS)")], True),
    # what the NaN repair costs: the order and the median network blind to
    # NaN (the result equals on a table without NaN)
    ("nan_blind", [
        ("csvec_topk.cu", "  if (n1 || n2) return n1 && (!n2 || i1 < i2);\n",
         ""),
        ("csvec_topk.cu", "      e[j] = min_nan(a, c);\n"
         "      e[j + 1] = max_nan(a, c);",
         "      e[j] = fminf(a, c);\n      e[j + 1] = fmaxf(a, c);")], True),
]


def main() -> int:
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from _mutate import build, loaded
    from repro_torch.configs import get_arch
    from repro_torch.countsketch.csvec import hash_params
    from repro_torch.kernels import _build
    from repro_torch.kernels import csvec_topk as KT
    from repro_torch.kernels.csvec_insert import csvec_insert
    from repro_torch.models.transformer import num_params

    print(chip_smoke.gpu_line(), flush=True)
    dev = torch.device("cuda")
    r, c, k = 5, 2**23, 256
    n = num_params(get_arch("tinyllama-1.1b"))
    params = hash_params(torch.Generator().manual_seed(r * 31 + c % 97), r)
    vec = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(7),
                      device=dev)
    tables = {"random": csvec_insert(torch.zeros((r, c), device=dev), params,
                                     vec),
              "flat": torch.full((r, c), 3.0, device=dev)}
    del vec
    want = {name: KT.csvec_topk_ref(t, params, n, k)
            for name, t in tables.items()}
    with tempfile.TemporaryDirectory() as tmp:
        for name, edits, checked in VARIANTS:
            lib_file = build("csvec_topk", Path(tmp), edits, name)
            usage = subprocess.run(
                [str(Path(_build.nvcc()).parent / "cuobjdump"), "-res-usage",
                 str(lib_file)], capture_output=True, text=True).stdout
            for fn, res in re.findall(r"Function (\S+):\s*\n\s*"
                                      r"(REG:\d+ STACK:\d+)", usage):
                print(name, fn, res, flush=True)
            with loaded("csvec_topk", lib_file, KT._bind):
                for label, table in tables.items():
                    def call():
                        return KT.csvec_topk(table, params, n, k)

                    got = call()
                    stats = KT.prune_stats()
                    equal = checked and all(
                        bool(torch.equal(g, w))
                        for g, w in zip(got, want[label]))
                    ms, call_ms = chip_smoke.time_ms(call, 3, 1)
                    seen = chip_smoke._device_kernels(call, 1) or {}
                    print(json.dumps(dict(
                        variant=name, table=label,
                        equal=equal if checked else None, ms=ms,
                        call_ms=call_ms,
                        kernel_us={key.split("(")[0].split("::")[-1]:
                                   [cnt, us] for key, (cnt, us)
                                   in seen.items()},
                        prune=stats)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
