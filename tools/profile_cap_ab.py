#!/usr/bin/env python3
"""Whether the cap on a timing's device profile (``chip_smoke.py``'s
``PROFILE_CALLS``) moves the kernel rows that ``chip_smoke.py`` reports.

    PYTHONPATH=src python3 tools/profile_cap_ab.py [A B]   # default 200 50

Runs ``chip_smoke.py``'s phase 2 (``phase_kernels``: the EMA update
kernels at every case, each timed by ``time_ms`` over 200 calls) with
the profile holding at most A calls, then B, B, A, each run a process
of its own (this script with ``--child N``), so that neither setting
always runs late in a process. Prints the card's name and power limit,
one JSON line a (run, row) (the device µs, where it came from:
``profile``, ``scaled`` or ``call``, the call µs and the run's wall
seconds) and then one line a row with its four device µs and their
sources, and the largest spread between the two runs of one setting and
between the settings' means, over the rows whose four readings all came
from a profile. Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def child(calls: int) -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.PROFILE_CALLS = calls
    for name in ("sketch_update", "psparse_update"):
        from repro_torch.kernels import _build
        _build.build(name)
    t0 = time.perf_counter()
    rows = chip_smoke.phase_kernels(torch.device("cuda", 0))
    wall = time.perf_counter() - t0
    for kernel, kernel_rows in rows.items():
        for i, r in enumerate(kernel_rows):
            print(json.dumps(dict(
                calls=calls, kernel=kernel, row=i, case=r["case"],
                a_dtype=r["a_dtype"], us=r["ms"] * 1e3, us_from=r["ms_from"],
                call_us=r["call_ms"] * 1e3, run_s=wall)), flush=True)
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        return child(int(sys.argv[2]))
    a, b = (int(x) for x in sys.argv[1:3]) if len(sys.argv) == 3 \
        else (200, 50)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    runs = []
    for calls in (a, b, b, a):
        proc = subprocess.run(
            [sys.executable, __file__, "--child", str(calls)],
            capture_output=True, text=True, cwd=ROOT)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        rows = [json.loads(x) for x in proc.stdout.splitlines()
                if x.startswith("{")]
        for r in rows:
            print(json.dumps(r), flush=True)
        runs.append(rows)
    within, between = 0.0, 0.0
    for i, r in enumerate(runs[0]):
        us = [run[i]["us"] for run in runs]
        src = [run[i]["us_from"] for run in runs]
        line = dict(kernel=r["kernel"], case=r["case"], a_dtype=r["a_dtype"],
                    us=us, us_from=src)
        if all(x == "profile" for x in src):
            line["within"] = max(abs(us[0] - us[3]) / us[0],
                                 abs(us[1] - us[2]) / us[1])
            line["between"] = abs((us[0] + us[3]) - (us[1] + us[2])) / (
                us[0] + us[3])
            within = max(within, line["within"])
            between = max(between, line["between"])
        print(json.dumps(line), flush=True)
    print(json.dumps(dict(
        calls=[a, b, b, a], run_s=[run[0]["run_s"] for run in runs],
        rows=len(runs[0]),
        not_from_a_profile=sum(x["us_from"] != "profile" for run in runs
                               for x in run),
        max_within=within, max_between=between)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
