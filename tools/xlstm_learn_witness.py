#!/usr/bin/env python3
"""Whether ten xlstm train steps can show learning, and what a broken
gradient reads: the witness for chip_smoke.py's XLSTM_LEARN_DROP.

    PYTHONPATH=src python3 tools/xlstm_learn_witness.py

Trains reduced xlstm-1.3b (and reduced tinyllama-1.1b beside it) on the
CPU with chip_smoke.py's xlstm settings (lr 3e-4, warmup 3 of 10 steps,
no global-norm clip, Gaussian monitor at k_max 9), B 4 x S 64, ten
steps each: on fresh batches, on one repeated batch, and on the
repeated batch with the mLSTM gradient's sign flipped
(``mlstm_chunk_bwd_plain``'s outputs negated).
Prints one JSON line a run: its losses and the relative drop of the
last-3 mean below the first-3 mean. About a minute.
"""
from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run(arch: str, repeat: bool, flip: bool) -> dict:
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.pipeline import PipelineConfig, host_batch
    from repro_torch.kernels import mlstm_chunk as MC
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step

    cfg = reduced(get_arch(arch))
    run_cfg = chip_smoke._xlstm_run_config("gaussian", 10, 4, 64)
    state = init_train_state(0, cfg, run_cfg, device="cpu")
    step = make_train_step(cfg, run_cfg)
    pipe = PipelineConfig(seed=0, global_batch=4, seq_len=64,
                          vocab=cfg.vocab_size)
    plain = MC.mlstm_chunk_bwd_plain
    if flip:
        MC.mlstm_chunk_bwd_plain = lambda *a, **k: tuple(
            -g for g in plain(*a, **k))
    losses = []
    try:
        for s in range(10):
            tokens, labels = host_batch(pipe, 0 if repeat else s)
            state, m = step(state, {"tokens": tokens, "labels": labels})
            losses.append(float(m["loss"]))
    finally:
        MC.mlstm_chunk_bwd_plain = plain
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    return dict(arch=arch, repeated_batch=repeat, mlstm_grad_flipped=flip,
                losses=losses, drop=(first - last) / first)


def main() -> None:
    for arch, repeat, flip in (("xlstm-1.3b", False, False),
                               ("tinyllama-1.1b", False, False),
                               ("xlstm-1.3b", True, False),
                               ("xlstm-1.3b", True, True)):
        print(json.dumps(run(arch, repeat, flip)), flush=True)


if __name__ == "__main__":
    main()
