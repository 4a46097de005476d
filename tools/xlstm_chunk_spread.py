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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lengths", type=int, nargs="+",
                    default=[16, 64, 256, 512])
    args = ap.parse_args(argv)
    cfg = reduced(get_arch("xlstm-1.3b"))
    params = transformer.init_params(jax.random.PRNGKey(0), cfg)
    port_cfg = port_reduced(port_get_arch("xlstm-1.3b"))
    port_params = params_from_jax(jax.tree.map(np.asarray, params))
    for length in args.lengths:
        print(json.dumps(spread(cfg, params, port_cfg, port_params, length)),
              flush=True)


if __name__ == "__main__":
    main()
