#!/usr/bin/env python3
"""xlstm-1.3b's gradient at its random init, and what the global-norm
clip does with it: the witness for chip_smoke.py's XLSTM_GRAD_CLIP.

    python3 tools/xlstm_grad_probe.py

On one CUDA device, at full width and all 48 layers (random weights from
seed 0, bf16 compute, no sketches), one JSON line a reading:

- ``norms``: one step's gradient at B 1 x S 64, 128, 256 and 512, with
  the mLSTM backward kernel, at S 512 also with its plain version (the
  reference's arithmetic in PyTorch) and in f32: the global norm, the
  largest leaves' norms and each layer's largest leaf norm;
- ``train``: 10 AdamW steps (chip_smoke.py's xlstm settings) on one
  repeated B 4 x S 512 batch with the global-norm clip at 1 (the
  launcher's) and off, and the clip at 1 twice (whether a run repeats
  bit for bit).

Builds the kernels first; about four minutes with the build.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def norms(cfg, S: int, plain: bool) -> dict:
    import torch
    from repro_torch.data.pipeline import PipelineConfig, host_batch
    from repro_torch.kernels import mlstm_chunk as MC
    from repro_torch.models.transformer import SketchSettings, init_params
    from repro_torch.optim.flat import get_path, leaf_paths
    from repro_torch.train.state import RunConfig
    from repro_torch.train.step import make_loss_and_grads

    dev = torch.device("cuda", 0)
    run = RunConfig(seq_len=S, global_batch=1,
                    sketch=SketchSettings(enabled=False))
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    tokens, labels = host_batch(PipelineConfig(
        seed=0, global_batch=1, seq_len=S, vocab=cfg.vocab_size), 0,
        device=dev)
    kernel = MC.mlstm_chunk_bwd
    if plain:
        MC.mlstm_chunk_bwd = MC.mlstm_chunk_bwd_plain
    try:
        loss, _, _, grads, _ = make_loss_and_grads(cfg, run)(
            types.SimpleNamespace(params=params, sketch=None),
            {"tokens": tokens, "labels": labels})
    finally:
        MC.mlstm_chunk_bwd = kernel
    by_leaf = {"/".join(map(str, p)): float(get_path(grads, p).float().norm())
               for p in leaf_paths(grads)}
    return dict(
        what="norms", S=S, dtype=str(cfg.dtype).split(".")[-1],
        backward="plain" if plain else "kernel", loss=float(loss),
        grad_norm=sum(v * v for v in by_leaf.values()) ** 0.5,
        top=sorted(by_leaf.items(), key=lambda kv: -kv[1])[:6],
        layer_max=[max(v for k, v in by_leaf.items()
                       if k.startswith(f"layers/{i}/"))
                   for i in range(cfg.num_layers)])


def train(cfg, clip: float) -> dict:
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.data.pipeline import PipelineConfig, host_batch
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step

    dev = torch.device("cuda", 0)
    run = chip_smoke._xlstm_run_config("gaussian", 10, 4, 512)
    run = dataclasses.replace(run, optimizer=dataclasses.replace(
        run.optimizer, grad_clip=clip))
    state = init_train_state(0, cfg, run, device=dev)
    step = make_train_step(cfg, run)
    tokens, labels = host_batch(PipelineConfig(
        seed=0, global_batch=4, seq_len=512, vocab=cfg.vocab_size), 0,
        device=dev)
    losses, norms_ = [], []
    for _ in range(10):
        state, m = step(state, {"tokens": tokens, "labels": labels})
        losses.append(float(m["loss"]))
        norms_.append(float(m["grad_norm"]))
    return dict(what="train", grad_clip=clip, losses=losses,
                grad_norms=norms_)


def main() -> None:
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    with concurrent.futures.ThreadPoolExecutor(len(chip_smoke.KERNELS)) as p:
        list(p.map(_build.build, chip_smoke.KERNELS))
    print(chip_smoke.gpu_line(), flush=True)
    cfg = get_arch("xlstm-1.3b")
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    for c, S, plain in ((cfg, 64, False), (cfg, 128, False),
                        (cfg, 256, False), (cfg, 512, False),
                        (cfg, 512, True), (f32, 512, False)):
        print(json.dumps(norms(c, S, plain)), flush=True)
        torch.cuda.empty_cache()
    for clip in (1.0, 1.0, 0.0):
        print(json.dumps(train(cfg, clip)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
