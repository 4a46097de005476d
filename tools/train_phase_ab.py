#!/usr/bin/env python3
"""Time chip_smoke.py's training runs in several checkouts, one process
each, in the order given (pass trees A B B A to compare two):

    python3 tools/train_phase_ab.py --what mnist_lm TREE [TREE ...]
    python3 tools/train_phase_ab.py --what lm_cs TREE [TREE ...]
    python3 tools/train_phase_ab.py --what lm_int8 TREE [TREE ...]

``mnist_lm`` runs ``phase_train_mnist`` and ``phase_lm_train``; ``lm_cs``
the LM phase's two compressed runs (fp32, then int8 + p2, in one
process, as phase 7 runs them); ``lm_int8`` the int8 + p2 run alone.
Each process builds the tree's kernels first. Prints one JSON line a
tree: step ms (median over steps 2-N); for the LM's compressed runs also
each step's ms and the device ms of one traced step (its kernels' sum),
which tell the host's share of a difference from the card's. Needs a
CUDA device.
"""
import argparse
import json
import subprocess
import sys

CODE = r'''
import concurrent.futures, json, sys
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from repro_torch.configs import get_arch
from repro_torch.kernels import _build
with concurrent.futures.ThreadPoolExecutor(len(cs.KERNELS)) as pool:
    list(pool.map(_build.build, cs.KERNELS))
dev = torch.device("cuda", 0)
what = sys.argv[1]
if what == "mnist_lm":
    out = {"mnist": {k: v["step_ms"] for k, v in
                     cs.phase_train_mnist(dev).items()},
           "lm": {k: v["step_ms"] for k, v in cs.phase_lm_train(dev).items()}}
else:
    modes = (("countsketch_fp32", "countsketch_int8_p2") if what == "lm_cs"
             else ("countsketch_int8_p2",))
    cfg = get_arch("tinyllama-1.1b")
    out = {}
    for m in modes:
        r = cs.lm_run(dev, cfg, m, "gaussian", cs.LM_STEPS)
        out[m] = {"step_ms": r["step_ms"],
                  "device_ms": r["profile"]["device_ms"],
                  "step_ms_samples": r["step_ms_samples"]}
print("RESULT " + json.dumps(out))
'''


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--what", choices=("mnist_lm", "lm_cs", "lm_int8"),
                    default="mnist_lm")
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    for tree in args.trees:
        p = subprocess.run([sys.executable, "-c", CODE, args.what], cwd=tree,
                           capture_output=True, text=True)
        line = [x for x in p.stdout.splitlines() if x.startswith("RESULT ")]
        if p.returncode or not line:
            print(p.stderr[-3000:], file=sys.stderr)
            return 1
        print(json.dumps({"tree": tree, **json.loads(line[0][7:])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
