#!/usr/bin/env python3
"""Run ``tools/dense_step.py`` against two or more checkouts in turn, in
the order A B B A (with three trees A B C C B A), so that their numbers
come from one card in one call.

    python3 tools/dense_step_ab.py TREE [TREE ...] -- DENSE_STEP_ARGS

    # this checkout against its parent, unpacked under artifacts/
    mkdir -p artifacts/parent
    git archive HEAD~1 | tar -x -C artifacts/parent
    python3 tools/dense_step_ab.py artifacts/parent . -- \\
        --batch 4 --seq 2048 --run tinyllama-1.1b:22:train
    # the compressed step and the data-parallel overlap step
    python3 tools/dense_step_ab.py artifacts/parent . -- --batch 8 \\
        --seq 128 --run tinyllama-1.1b:22:train_cs,train_dp_overlap_w2

Each TREE is the root of a checkout; every run is one process of this
checkout's ``tools/dense_step.py`` with ``PYTHONPATH`` at that tree's
``src``, so each tree's kernels build into its own ``_build``. Prints
the card's name and power limit, then for each run a line ``== TREE
ARGS`` and the run's JSON lines. Exits 1 if a run did.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv: list[str]) -> int:
    if "--" not in argv or argv.index("--") < 2:
        print(__doc__, file=sys.stderr)
        return 2
    cut = argv.index("--")
    trees, args = argv[:cut], argv[cut + 1:]
    for tree in trees:
        if not (Path(tree) / "src" / "repro_torch").is_dir():
            print(f"{tree} holds no src/repro_torch", file=sys.stderr)
            return 2
    if shutil.which("nvidia-smi"):
        subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], check=False)
    rc = 0
    for tree in trees + trees[::-1]:
        print(f"== {tree} {' '.join(args)}", flush=True)
        env = dict(os.environ,
                   PYTHONPATH=str((Path(tree) / "src").resolve()))
        run = subprocess.run(
            [sys.executable, str(ROOT / "tools" / "dense_step.py"), *args],
            env=env, check=False)
        rc |= run.returncode != 0
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
