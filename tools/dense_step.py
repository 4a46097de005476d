#!/usr/bin/env python3
"""Time a dense config's LM train step and its prefill on one device,
at full width and cut in depth, through the ``repro_torch`` package
that ``PYTHONPATH`` names.

    PYTHONPATH=src python3 tools/dense_step.py \
        --run granite-34b:2:train,prefill --batch 2 --seq 2048

Each ``--run ARCH:LAYERS:WHAT`` builds ARCH with its first LAYERS
layers (random weights from seed 0) and measures WHAT, a comma list of

- ``train``: the LM train step as ``launch/train.py`` builds it
  (sketched FFN, k_max 17, AdamW lr 3e-4) on (batch, seq) batches of the
  synthetic pipeline: ``--warmup`` steps, then the median host time of
  ``--steps`` steps, each ending in the loss's device sync (a garbage
  collection follows each step, untimed, so that a version whose step
  leaves reference cycles holds no more memory than one whose step does
  not), and the device memory allocated (now and at its peak) after the state's
  init, after the first step's gradients, after that step and after
  the last;
- ``train_cs``: the same step with the fp32 count-sketch compression
  (``CompressionConfig(mode="countsketch")``: a 5 x 2^23 table at
  tinyllama-1.1b, one ``csvec_insert`` and one ``csvec_topk`` a step);
- ``train_dp_overlap_w2``: the data-parallel step of 2 workers in one
  process, overlap layout, int8 sketch wire through the ring, the fp32
  count sketch with p2 2 (two ring merges and an insert a worker a
  step), every step whole;
- ``prefill``: ``ServeEngine.start`` (monitor off) of a (batch, seq)
  random prompt batch: ``--warmup`` prefills, then the median of
  ``--steps``.

It calls only entry points that every version of the port has had, so
two checkouts compare on one card by running it with ``PYTHONPATH`` at
each checkout's ``src`` in turn (A, B, B, A). One JSON line a run goes
to standard output; a run out of device memory says so in its line,
the next run goes on, and the exit code is 1. ``--device cpu
--reduced`` rehearses it on a CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


# the train step's variants: RunConfig fields beside the defaults (the
# compressed LM step and the data-parallel overlap step of chip_smoke.py's
# phases 7 (b) and 9 (b))
TRAIN_VARIANTS = {
    "train": {},
    "train_cs": dict(compression=dict(mode="countsketch")),
    "train_dp_overlap_w2": dict(
        compression=dict(mode="countsketch", cs_p2=2), dp_axis_name="data",
        dp_workers=2, dp_collective="overlap", sketch_wire_dtype="int8",
        ring_wire=True),
}


def train_ms(cfg, dev, batch: int, seq: int, warmup: int, steps: int,
             variant: str = "train"):
    import gc

    import torch
    from repro_torch.data.pipeline import PipelineConfig, host_batch
    from repro_torch.models.transformer import SketchSettings
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compression import CompressionConfig
    from repro_torch.train.state import RunConfig, init_train_state
    from repro_torch.train.step import make_train_step

    n = warmup + steps
    extra = dict(TRAIN_VARIANTS[variant])
    if "compression" in extra:
        extra["compression"] = CompressionConfig(**extra["compression"])
    run = RunConfig(seq_len=seq, global_batch=batch,
                    optimizer=AdamWConfig(lr=3e-4),
                    warmup_steps=min(20, n // 5 + 1), total_steps=n,
                    sketch=SketchSettings(enabled=True, k_max=17), **extra)
    pipe = PipelineConfig(seed=0, global_batch=batch, seq_len=seq,
                          vocab=cfg.vocab_size)
    state = init_train_state(0, cfg, run, device=dev)
    step = make_train_step(cfg, run)
    cuda = dev.type == "cuda"
    mem = {}

    def mark(name):
        if cuda:
            torch.cuda.synchronize()
            mem[f"{name}_mib"] = torch.cuda.memory_allocated() / 2**20
            mem[f"{name}_peak_mib"] = (torch.cuda.max_memory_allocated()
                                       / 2**20)

    mark("state")
    times, losses = [], []
    for s in range(n):
        tokens, labels = host_batch(pipe, s, device=dev)
        t0 = time.perf_counter()
        if s == 0 and hasattr(step, "loss_and_grads"):
            # the two halves apart: the memory after each
            res = step.loss_and_grads(state, {"tokens": tokens,
                                              "labels": labels})
            mark("grads")
            state, m = step.apply_grads(state, *res)
            del res
            mark("first_step")
        else:
            state, m = step(state, {"tokens": tokens, "labels": labels})
        losses.append(float(m["loss"]))        # the loss's device sync
        times.append((time.perf_counter() - t0) * 1e3)
        gc.collect()
    mark("last_step")
    pre = "" if variant == "train" else f"{variant}_"
    return {f"{variant}_step_ms": statistics.median(times[warmup:]),
            f"{variant}_step_ms_samples": times[warmup:],
            f"{pre}losses": losses, **{pre + k: v for k, v in mem.items()}}


def prefill_ms(cfg, dev, batch: int, seq: int, warmup: int, steps: int):
    import torch
    from repro_torch.models.transformer import cast_params, init_params
    from repro_torch.serve import ServeEngine

    gen = torch.Generator(device=dev).manual_seed(0)
    params = cast_params(init_params(gen, cfg), cfg.dtype, dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                            device=dev)
    eng = ServeEngine(cfg=cfg, params=params, max_context=seq, device=dev)
    times = []
    for _ in range(warmup + steps):
        _sync(dev)
        t0 = time.perf_counter()
        tok = eng.start(prompts)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    if not bool(((tok >= 0) & (tok < cfg.vocab_size)).all()):
        raise AssertionError(f"prefill gave tokens outside the vocab: {tok}")
    return dict(prefill_ms=statistics.median(times[warmup:]),
                prefill_ms_samples=times[warmup:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", action="append", required=True,
                    metavar="ARCH:LAYERS:WHAT")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the configs' reduced widths (a CPU rehearsal)")
    args = ap.parse_args(argv)

    import gc

    import torch
    from repro_torch.configs import get_arch, reduced

    dev = torch.device(args.device)
    failed = False
    for spec in args.run:
        arch, layers, what = spec.split(":")
        cfg = get_arch(arch)
        if args.reduced:
            cfg = reduced(cfg)
        cfg = dataclasses.replace(cfg, num_layers=int(layers))
        out = dict(arch=arch, layers=int(layers), batch=args.batch,
                   seq=args.seq, reduced=args.reduced)
        for w in what.split(","):
            try:
                if w in TRAIN_VARIANTS:
                    out.update(train_ms(cfg, dev, args.batch, args.seq,
                                        args.warmup, args.steps, w))
                else:
                    out.update(prefill_ms(cfg, dev, args.batch, args.seq,
                                          args.warmup, args.steps))
            except torch.OutOfMemoryError as e:   # reported, and rc 1
                failed = True
                out[f"{w}_error"] = str(e).split("\n")[0]
                out[f"{w}_error_peak_mib"] = (
                    torch.cuda.max_memory_allocated() / 2**20)
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        print(json.dumps(out), flush=True)
    return int(failed)


if __name__ == "__main__":
    raise SystemExit(main())
