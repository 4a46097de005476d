#!/usr/bin/env python3
"""Compare the ``mlstm_chunk`` and ``mlstm_chunk_bwd`` kernels of one or
more checkouts on the card: agreement with their plain versions and the
time of a call, the forward at xlstm-1.3b's serving and refill shapes
(bf16 and f32) and two small ones, the backward at its train shapes (B 4
x S 512 in bf16 and f32, B 1 x S 2048 in bf16, the model's forget gates).

    python3 tools/mlstm_chunk_ab.py [TREE ...]     # on a Hopper card

    # this checkout against its parent, unpacked under artifacts/
    mkdir -p artifacts/parent
    git archive HEAD~1 | tar -x -C artifacts/parent
    python3 tools/mlstm_chunk_ab.py artifacts/parent .

Each TREE (default: this checkout) is the root of a checkout; the trees
run in the order A B B A, each run one process of this script with
``PYTHONPATH`` at that tree's ``src``, so that each tree's wrapper
launches its own kernels, built into its own ``_build``. Prints the
card's name and power limit, then a line ``== TREE`` a run, each
build's register and spill lines (first run of a tree) and one JSON
line a case: the errors of h, C and n relative to max|plain| (the
backward: the largest share of ``bwd_gap``'s allowance a gradient uses),
ms a call over 5 calls (CUDA events), the plain version's ms, and
``torch.profiler``'s µs a call of each kernel (null where the profiler
lost its markers). Exits 1 if a run did.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# B, H, S, Dk, Dv, chunk, input type
CASES = (("serve", 8, 4, 2048, 512, 1024, 256, "bfloat16"),
         ("refill", 1, 4, 512, 512, 1024, 256, "bfloat16"),
         ("serve_f32", 8, 4, 2048, 512, 1024, 256, "float32"),
         ("ragged", 2, 3, 96, 24, 70, 32, "float32"),
         ("small_bf16", 2, 2, 40, 8, 16, 256, "bfloat16"))
# the backward: B, H, S, Dk, Dv, chunk, input type; lf = logsigmoid(b_h
# + N(0, 1)), b_h = linspace(3, 6) over the heads (models/ssm.py)
BWD_CASES = (("bwd_train", 4, 4, 512, 512, 1024, 256, "bfloat16"),
             ("bwd_ctx", 1, 4, 2048, 512, 1024, 256, "bfloat16"),
             ("bwd_train_f32", 4, 4, 512, 512, 1024, 256, "float32"))
CALLS = 5


def ms_a_call(fn, calls: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(calls):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / calls


def one(tree: str) -> None:
    """The cases on the package that PYTHONPATH names."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import mlstm_chunk as MC

    for name in ("mlstm_chunk", "mlstm_chunk_bwd"):
        log = _build.build(name).splitlines()
        print(*(ln for ln in log if "Used" in ln or "spill" in ln),
              sep="\n", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, B, H, S, Dk, Dv, chunk, dt in CASES:
        dt = getattr(torch, dt)
        q, k = (torch.randn((B, H, S, Dk), generator=gen, device="cuda")
                .to(dt) for _ in range(2))
        # v as the model passes it: a (B, H, S, Dv) view of (B, S, H, Dv)
        v = torch.randn((B, S, H, Dv), generator=gen, device="cuda").to(
            dt).transpose(1, 2)
        li = torch.randn((B, H, S), generator=gen, device="cuda") * 0.5
        lf = torch.nn.functional.logsigmoid(
            torch.randn((B, H, S), generator=gen, device="cuda") + 2)
        args = (q, k, v, li, lf)
        want = MC.mlstm_chunk_plain(*args, chunk=chunk)

        def call():
            return MC.mlstm_chunk(*args, chunk=chunk)

        h, (C, n, _) = call()
        errs = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip((h, C, n), (want[0],) + want[1][:2])]
        split = chip_smoke._device_kernels(call, 2)
        print(json.dumps(dict(
            tree=tree, case=label, shape=[B, H, S, Dk, Dv], chunk=chunk,
            dtype=str(dt).split(".")[-1], rel_err_h_C_n=errs,
            ms=ms_a_call(call, CALLS),
            plain_ms=ms_a_call(lambda: MC.mlstm_chunk_plain(
                *args, chunk=chunk), 2),
            kernel_us=split and {name: us / 2 for name, (_, us)
                                 in split.items()})), flush=True)
        del args, q, k, v, want, h, C, n
        torch.cuda.empty_cache()
    for label, B, H, S, Dk, Dv, chunk, dt in BWD_CASES:
        dt = getattr(torch, dt)
        q, k = (torch.randn((B, H, S, Dk), generator=gen, device="cuda")
                .to(dt) for _ in range(2))
        v = torch.randn((B, S, H, Dv), generator=gen, device="cuda").to(
            dt).transpose(1, 2)
        li = torch.randn((B, H, S), generator=gen, device="cuda") * 0.5
        lf = torch.nn.functional.logsigmoid(
            torch.randn((B, H, S), generator=gen, device="cuda")
            + torch.linspace(3.0, 6.0, H, device="cuda")[:, None])
        h, _ = MC.mlstm_chunk(q, k, v, li, lf, chunk=chunk)
        dh = torch.randn((B, H, S, Dv), generator=gen, device="cuda")
        args = (q, k, v, li, lf, h, dh)

        def call():
            return MC.mlstm_chunk_bwd(*args, chunk=chunk)

        want = MC.mlstm_chunk_bwd_plain(q.float(), k.float(), v.float(), li,
                                        lf, h, dh, chunk=chunk)
        used = max(MC.bwd_gap(g, w) for g, w in zip(call(), want))
        split = chip_smoke._device_kernels(call, 2)
        print(json.dumps(dict(
            tree=tree, case=label, shape=[B, H, S, Dk, Dv], chunk=chunk,
            dtype=str(dt).split(".")[-1], allowance_used=used,
            ms=ms_a_call(call, CALLS),
            plain_ms=ms_a_call(lambda: MC.mlstm_chunk_bwd_plain(
                *args, chunk=chunk), 2),
            kernel_us=split and {name: us / 2 for name, (_, us)
                                 in split.items()})), flush=True)
        del args, q, k, v, h, dh, want
        torch.cuda.empty_cache()


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        one(argv[1])
        return 0
    trees = argv or [str(ROOT)]
    for tree in trees:
        if not (Path(tree) / "src" / "repro_torch").is_dir():
            print(f"{tree} holds no src/repro_torch", file=sys.stderr)
            return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rc = 0
    for tree in trees + trees[::-1]:
        print(f"== {tree}", flush=True)
        env = dict(os.environ,
                   PYTHONPATH=str((Path(tree) / "src").resolve()))
        rc |= subprocess.run([sys.executable, __file__, "--one", tree],
                             env=env, check=False).returncode != 0
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
