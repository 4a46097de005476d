"""LM training launcher on one device (counterpart of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch tinyllama-1.1b --reduced --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --reduced --compress countsketch --cs-p2 2 --wire-dtype int8
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --dp 4 --dp-collective overlap --sketch-wire-dtype int8 \\
        --ring-wire --compress countsketch --cs-p2 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch recurrentgemma-2b --reduced --dp 2 --batch 4 --device cpu

Runs on the CUDA device unless ``--device`` names another: sketched
backprop on the FFN (``--no-sketch`` for exact backprop), AdamW with
warmup-cosine, the NaN guard, checkpoints every ``--ckpt-every`` steps,
and optional count-sketch (or top-k) gradient compression. ``--dp W``
runs the data-parallel step with W workers in this process (every arch
but the MoE ones, ROADMAP A17), in the ``--dp-collective`` layout, with
the sketch increments on an fp32 or int8 wire (``--sketch-wire-dtype``;
``--wire-dtype`` is the count-sketch table's) and, with ``--ring-wire``,
merged through the ring kernel. The
reference's mesh flags (``--dp-pods``, ``--dp-merge reduce_scatter``,
``--debug-mesh``, ``--multi-pod``) raise, naming ROADMAP A14. Like the
reference's, the launcher builds no patch embeddings for internvl2-76b:
its batches are tokens alone.
"""
from __future__ import annotations

import argparse
import logging

from repro_torch.configs import get_arch, reduced as reduce_cfg
from repro_torch.models.transformer import SketchSettings
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compression import CompressionConfig
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.state import ConfigError, RunConfig

# the reference's mesh flags, which ROADMAP A14 ports
NOT_PORTED = ("dp_pods", "debug_mesh", "multi_pod")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-runnable reduced config")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--compress", default="none",
                    choices=["none", "topk", "countsketch"],
                    help="gradient compression mode")
    ap.add_argument("--cs-p2", type=int, default=0,
                    help="countsketch second-round candidate multiplier "
                         "(SketchedSGD p2; 0 disables)")
    ap.add_argument("--wire-dtype", default="fp32", choices=["fp32", "int8"],
                    help="precision of the count-sketch table on the wire")
    ap.add_argument("--no-sketch", action="store_true",
                    help="exact backprop (no sketch tree)")
    ap.add_argument("--proj-kind", default="gaussian",
                    choices=["gaussian", "psparse"],
                    help="sketch projection family")
    ap.add_argument("--proj-density", type=float, default=0.1,
                    help="psparse nonzero fraction p")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt_launch")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--dp", type=int, default=0, metavar="W",
                    help="W data-parallel workers, run in this process "
                         "(the global batch must divide by W)")
    ap.add_argument("--dp-collective", default="fused",
                    choices=["fused", "per_node", "overlap"],
                    help="data-parallel collective layout")
    ap.add_argument("--sketch-wire-dtype", default="fp32",
                    choices=["fp32", "int8"],
                    help="precision of the sketch increments on the "
                         "data-parallel wire")
    ap.add_argument("--ring-wire", action="store_true",
                    help="merge the flat-segment buffer through the ring "
                         "all-reduce kernel instead of the psum")
    ap.add_argument("--dp-merge", default="psum",
                    choices=["psum", "reduce_scatter"])
    ap.add_argument("--dp-pods", type=int, default=0, metavar="P")
    ap.add_argument("--debug-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    for flag in NOT_PORTED:
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet: ROADMAP A14")

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    compression = None
    if args.compress != "none":
        compression = CompressionConfig(mode=args.compress, cs_p2=args.cs_p2,
                                        wire_dtype=args.wire_dtype)
    try:
        run = RunConfig(
            seq_len=args.seq_len, global_batch=args.batch,
            optimizer=AdamWConfig(lr=args.lr),
            warmup_steps=min(20, args.steps // 5 + 1),
            total_steps=args.steps,
            sketch=SketchSettings(enabled=not args.no_sketch, k_max=17,
                                  proj_kind=args.proj_kind,
                                  proj_density=args.proj_density),
            compression=compression,
            dp_axis_name="data" if args.dp else None,
            dp_workers=args.dp or 1, dp_collective=args.dp_collective,
            dp_merge=args.dp_merge, sketch_wire_dtype=args.sketch_wire_dtype,
            ring_wire=args.ring_wire)
    except ConfigError as e:
        raise SystemExit(f"invalid flag combination: {e}")
    loop = LoopConfig(num_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir, log_every=10)
    state, hist = run_training(cfg, run, loop, device=args.device)
    # a rerun resumes from the checkpoint of its last step and takes none
    final = f"final loss {hist[-1]['loss']:.4f}" if hist else \
        f"resumed at step {state.step}"
    print(f"done: {len(hist)} steps, {final}, skipped {state.skipped}",
          flush=True)
    return state, hist


if __name__ == "__main__":
    main()
