"""Serving launcher: batched greedy generation with random weights.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch tinyllama-1.1b --monitor [--device cpu] [--reduced]
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch xlstm-1.3b --reduced --device cpu --prompt-len 16
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-2b --reduced --device cpu --prompt-len 40
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch musicgen-large --reduced --device cpu --monitor

Every registered arch serves, internvl2-76b on its tokens alone (the
engine takes no patch embeddings, as the reference's).

An arch with mLSTM blocks (xlstm-1.3b) takes prompts of at most 256
tokens or a multiple of 256.

Runs on the CUDA device unless ``--device`` names another. ``--monitor``
updates the per-layer activation sketches in every serve step and prints
the pathology flags; ``--telemetry-json PATH`` exports the run as
schema-versioned JSONL.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch, reduced as reduce_cfg
from repro_torch.models.transformer import init_params
from repro_torch.device import resolve_device
from repro_torch.serve.engine import ServeEngine
from repro_torch.telemetry import TelemetryLog


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-prompts", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-context", type=int, default=64)
    ap.add_argument("--monitor", action="store_true",
                    help="live activation sketches in the serve steps")
    ap.add_argument("--monitor-rank", type=int, default=4)
    ap.add_argument("--telemetry-json", default=None, metavar="PATH",
                    help="export TelemetryRecords as JSONL")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = init_params(gen, cfg)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.num_prompts, args.prompt_len),
                            generator=gen, device=device)

    tlog = TelemetryLog(args.telemetry_json) if args.telemetry_json \
        else None
    engine = ServeEngine(cfg=cfg, params=params,
                         max_context=args.max_context, monitor=args.monitor,
                         monitor_rank=args.monitor_rank, telemetry_log=tlog,
                         device=device)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.max_new)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0

    tput = args.num_prompts * args.max_new / dt
    print(f"generated {tuple(out.shape)} on {device} in {dt:.2f}s "
          f"({tput:.1f} tok/s incl. kernel build)")
    for i in range(min(2, args.num_prompts)):
        print(f"  prompt {i}: {out[i].tolist()}")
    if args.monitor:
        rec = engine.telemetry_record()
        if rec.flags:
            print("pathology flags:")
            for name, paths in sorted(rec.flags.items()):
                print(f"  {name}: {', '.join(paths)}")
        else:
            print("pathology flags: none")
    if tlog is not None:
        tlog.close()
        print(f"telemetry: {tlog.records_written} record(s) -> "
              f"{args.telemetry_json}")
    return out


if __name__ == "__main__":
    main()
