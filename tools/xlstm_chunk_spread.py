#!/usr/bin/env python3
"""How closely reduced xlstm's prefill can be asked to agree with the JAX
reference, and how far a wrong implementation lands.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/xlstm_chunk_spread.py

Runs the prefill forward of reduced xlstm-1.3b (the reference's weights
from seed 0, carried to the port by ``params_from_jax``; 2 random
prompts a length) at each ``--lengths`` and prints one JSON line a
length. Each reading is the largest absolute difference from the
reference at chunk 256, relative to the reference's largest magnitude,
of the logits and of the recurrent caches (the worst entry over every
layer):

- ``ref_chunk64``, ``ref_chunk16``: the reference itself with another
  mLSTM chunk, the same function summed in another order;
- ``port``: the port's prefill on the CPU (``mlstm_chunk_plain``);
- ``port_bf16_qk``: the port with q and k rounded to bf16 before the
  chunk, a deliberately degraded run.

The spread of the first two sets how closely any other implementation
can agree with the reference on this random model, whose layers amplify
rounding over long prompts; the degraded run shows what a wrong one
reads. CPU only; a few seconds a length.

With ``--train`` it reads one train step instead (B 2 x S ``--lengths``,
Gaussian monitor sketches at k_max 9, from the reference's
``init_train_state(PRNGKey(0))``), at 8 and 16 layers
(``layers_per_pattern`` 1 and 2): the loss and the new "res", "mlstm_c"
and "mlstm_n" triples of the reference at chunk 64 and of the port,
each against the reference at chunk 256 (about 30 s a reading).

With ``--conditioning`` it reads how far one f32 rounding moves the
port's gradient of one train step of reduced xlstm (8 layers, B 2 x S
``--lengths``, weights from the port's seed 0 and chip_smoke.py's
xlstm settings, as its card-against-CPU steps) at each mLSTM
``--chunks``: every weight scaled by 1 + 1e-7 N(0, 1), one reading for
each of ``--seeds`` perturbation seeds, the largest change of a
gradient leaf relative to its max (and, at a chunk other than 256, the
unperturbed gradient against chunk 256's). Two correct f32
implementations can agree no closer than the spread of these readings.
"""
from __future__ import annotations

import argparse
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch, reduced
from repro.models import ssm
from repro.models import transformer
from repro_torch.configs import get_arch as port_get_arch
from repro_torch.configs import reduced as port_reduced
from repro_torch.interop import params_from_jax
from repro_torch.models import ssm as port_ssm
from repro_torch.models import transformer as port_transformer


def _reference(cfg, params, tokens, chunk: int):
    apply = ssm.mlstm_apply
    try:
        ssm.mlstm_apply = functools.partial(apply, chunk=chunk)
        out = jax.jit(lambda p, t: transformer.forward(
            p, t, cfg=cfg, mode="prefill"))(params, jnp.asarray(tokens))
    finally:
        ssm.mlstm_apply = apply
    P = len(cfg.pattern)
    caches = [{name: np.asarray(t)[layer // P]
               for name, t in out["cache"]["groups"][layer % P].items()}
              for layer in range(cfg.num_layers)]
    return np.asarray(out["logits"]), caches


def _port(cfg, params, tokens, round_qk: bool):
    chunk = port_ssm.mlstm_chunk

    def bf16_qk(q, k, *rest, **kw):
        return chunk(q.bfloat16().float(), k.bfloat16().float(), *rest, **kw)

    try:
        if round_qk:
            port_ssm.mlstm_chunk = bf16_qk
        with torch.no_grad():
            out = port_transformer.forward(params, torch.from_numpy(tokens),
                                           cfg=cfg, mode="prefill")
    finally:
        port_ssm.mlstm_chunk = chunk
    caches = [{name: t.numpy() for name, t in layer.items()}
              for layer in out["cache"]]
    return out["logits"].numpy(), caches


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _reading(got, want) -> dict:
    (logits, caches), (w_logits, w_caches) = got, want
    return dict(logits=_rel(logits, w_logits),
                caches=max(_rel(c[name], w[name])
                           for c, w in zip(caches, w_caches) for name in w))


def spread(cfg, params, port_cfg, port_params, length: int) -> dict:
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (2, length)).astype(np.int32)
    base = _reference(cfg, params, tokens, 256)
    out = dict(length=length, max_abs_logit=float(np.abs(base[0]).max()))
    for chunk in (64, 16):
        out[f"ref_chunk{chunk}"] = _reading(
            _reference(cfg, params, tokens, chunk), base)
    for name, round_qk in (("port", False), ("port_bf16_qk", True)):
        out[name] = _reading(_port(port_cfg, port_params, tokens, round_qk),
                             base)
    return out


def _train_step(layers_per_pattern: int, length: int, chunk: int | None):
    """(loss, {node: (x, y, z)}) after one train step of the reference at
    mLSTM chunk ``chunk``, or of the port with ``chunk`` None."""
    from repro.train.state import RunConfig, init_train_state
    from repro.train.step import make_train_step
    from repro_torch.interop import tree_from_jax
    from repro_torch.train.state import RunConfig as PortRun
    from repro_torch.train.state import init_train_state as port_init
    from repro_torch.train.step import make_train_step as port_step

    kw = dict(seq_len=length, global_batch=2, warmup_steps=2,
              total_steps=40)
    st = dict(enabled=True, k_max=9, beta=0.9, recon_mode="fast")
    cfg = reduced(get_arch("xlstm-1.3b"),
                  layers_per_pattern=layers_per_pattern)
    run = RunConfig(**kw, sketch=transformer.SketchSettings(**st))
    state = init_train_state(jax.random.PRNGKey(0), cfg, run)
    tok = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                            (2, length + 1))
    if chunk is None:
        pcfg = port_reduced(port_get_arch("xlstm-1.3b"),
                            layers_per_pattern=layers_per_pattern)
        prun = PortRun(**kw, sketch=port_transformer.SketchSettings(**st))
        pstate = port_init(0, pcfg, prun, device="cpu", params=params_from_jax(
            jax.tree.map(np.asarray, state.params)), sketch=tree_from_jax(
                jax.tree.map(np.asarray, state.sketch)))
        pstate, m = port_step(pcfg, prun)(pstate, {
            "tokens": torch.from_numpy(tok[:, :-1]),
            "labels": torch.from_numpy(tok[:, 1:])})
        return float(m["loss"]), {n: tuple(getattr(v, a).numpy() for a in "xyz")
                                  for n, v in pstate.sketch.nodes.items()}
    apply = ssm.mlstm_apply
    try:
        ssm.mlstm_apply = functools.partial(apply, chunk=chunk)
        state, m = jax.jit(make_train_step(cfg, run))(state, {
            "tokens": jnp.asarray(tok[:, :-1]),
            "labels": jnp.asarray(tok[:, 1:])})
    finally:
        ssm.mlstm_apply = apply
    return float(m["loss"]), {n: tuple(np.asarray(getattr(v, a)) for a in "xyz")
                              for n, v in state.sketch.nodes.items()}


def train_spread(layers_per_pattern: int, length: int) -> dict:
    base = _train_step(layers_per_pattern, length, 256)
    out = dict(layers=8 * layers_per_pattern, length=length)
    for name, chunk in (("ref_chunk64", 64), ("port", None)):
        loss, trees = _train_step(layers_per_pattern, length, chunk)
        out[name] = dict(loss=abs(loss - base[0]) / abs(base[0]), **{
            node: max(_rel(g, w) for g, w in zip(trees[node], base[1][node]))
            for node in base[1]})
    return out


def conditioning(length: int, seeds: int, chunk: int) -> dict:
    import sys
    import types
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    from repro_torch.data.pipeline import PipelineConfig, host_batch
    from repro_torch.optim.flat import leaf_paths, tree_leaves, tree_map
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_loss_and_grads

    cfg = port_reduced(port_get_arch("xlstm-1.3b"))
    run = chip_smoke._xlstm_run_config("gaussian", 1, 2, length)
    tokens, labels = host_batch(PipelineConfig(
        seed=3, global_batch=2, seq_len=length, vocab=cfg.vocab_size), 0)
    params = init_train_state(0, cfg, run, device="cpu").params
    step = make_loss_and_grads(cfg, run)
    apply = port_ssm.mlstm_apply

    def grads(p, chunk=chunk):
        try:
            port_ssm.mlstm_apply = functools.partial(apply, chunk=chunk)
            return step(types.SimpleNamespace(params=p, sketch=None),
                        {"tokens": tokens, "labels": labels})[3]
        finally:
            port_ssm.mlstm_apply = apply

    base = grads(params)
    readings = []
    for seed in range(1, seeds + 1):
        gen = torch.Generator().manual_seed(seed)
        moved = grads(tree_map(lambda t: t * (1 + 1e-7 * torch.randn(
            t.shape, generator=gen)), params))
        readings.append(max((float((a - b).abs().max() / b.abs().max()),
                             "/".join(map(str, p))) for a, b, p in zip(
            tree_leaves(moved), tree_leaves(base), leaf_paths(base))))
    moved = sorted(r[0] for r in readings)
    out = dict(length=length, chunk=chunk, seeds=seeds,
               gradient_moved=[r[0] for r in readings],
               leaves=sorted({r[1] for r in readings}), min=moved[0],
               median=moved[len(moved) // 2], max=moved[-1])
    if chunk != 256:
        # the same function summed in another order: against chunk 256
        out["against_chunk256"] = max(
            float((a - b).abs().max() / b.abs().max())
            for a, b in zip(tree_leaves(base), tree_leaves(grads(params,
                                                                 256))))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lengths", type=int, nargs="+",
                    default=[16, 64, 256, 512])
    ap.add_argument("--train", action="store_true",
                    help="read one train step at 8 and 16 layers")
    ap.add_argument("--conditioning", action="store_true",
                    help="how far one f32 rounding moves the gradient")
    ap.add_argument("--seeds", type=int, default=8,
                    help="--conditioning: perturbations, one seed each")
    ap.add_argument("--chunks", type=int, nargs="+", default=[256],
                    help="--conditioning: the mLSTM chunks to read at")
    args = ap.parse_args(argv)
    if args.conditioning:
        for length in args.lengths:
            for chunk in args.chunks:
                print(json.dumps(conditioning(length, args.seeds, chunk)),
                      flush=True)
        return
    if args.train:
        for length in args.lengths:
            for lpp in (1, 2):
                print(json.dumps(train_spread(lpp, length)), flush=True)
        return
    cfg = reduced(get_arch("xlstm-1.3b"))
    params = transformer.init_params(jax.random.PRNGKey(0), cfg)
    port_cfg = port_reduced(port_get_arch("xlstm-1.3b"))
    port_params = params_from_jax(jax.tree.map(np.asarray, params))
    for length in args.lengths:
        print(json.dumps(spread(cfg, params, port_cfg, port_params, length)),
              flush=True)


if __name__ == "__main__":
    main()
