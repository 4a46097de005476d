#!/usr/bin/env python3
"""Does the CIFAR hybrid learn at the JAX reference's own settings?

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python3 tools/hybrid_witness.py \
        [--steps 100] [--data bench|stand_in] [--seed 7] [--lr 1e-3]

Trains the reference's hybrid step (``benchmarks/bench_cifar_hybrid.py``
``_make_step``, its joint regime: stem and tail from scratch together)
with exact gradients (``standard``) and with the sketched tail
(``sketched_fixed``), B 128, Adam at ``--lr`` (``CIFAR_HYBRID``'s
learning rate unless given), from one init, and prints one JSON line a variant: the mean loss of the
first and last 10 steps, the largest loss and the accuracy on 1,024
held-out images. Beside each, the port's hybrid step
(``repro_torch.train.paper_trainer.make_hybrid_step``) on the CPU from
the same init, tree and batches: its first and last 10 steps' mean loss
and the step where its loss first leaves the reference's by more than
1e-3 relative (rounding grows through Adam; null if it never does).

``--data bench`` draws the benchmark's images (``class_prototypes`` +
unit noise, ``image_batch``); ``--data stand_in`` the conv family's
stand-in CIFAR batch (``repro.models.frontends.fake_cifar_batch``'s
law: N(0, 1) prototypes a pixel, noise 0.5). The standard run is the
witness: a sketched run that ends where exact gradients end says
nothing about the sketch. CPU only; a few seconds a variant.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics

import jax
import jax.numpy as jnp
import numpy as np
import torch

from benchmarks.bench_cifar_hybrid import _make_step
from repro.configs.paper import CIFAR_HYBRID
from repro.core.sketch import SketchConfig
from repro.data.synthetic import class_prototypes, image_batch
from repro.models.mlp import conv_stem_apply, conv_stem_init, mlp_init
from repro.optim.adamw import AdamWConfig, init_adamw
from repro.train.paper_trainer import init_mlp_sketch, plain_forward
from repro_torch.configs.paper import CIFAR_HYBRID as PORT_CFG
from repro_torch.core.sketch import SketchConfig as PortSketchConfig
from repro_torch.interop import mlp_params_from_jax, tree_from_jax
from repro_torch.optim.adamw import AdamWConfig as PortAdamWConfig
from repro_torch.optim.adamw import init_adamw as port_init_adamw
from repro_torch.train.paper_trainer import make_hybrid_step


def _port(params, sk):
    """The reference's init and tree as the port's, on the CPU."""
    stem = {k: torch.from_numpy(np.array(v)) for k, v in params["stem"].items()}
    mlp = mlp_params_from_jax(jax.tree.map(np.asarray, params["mlp"]))
    return {"stem": stem, "mlp": mlp}, tree_from_jax(jax.tree.map(np.asarray,
                                                                  sk))


def _data(key, data: str, batch: int):
    if data == "bench":
        protos = class_prototypes(key, 10, 32 * 32 * 3)
        return lambda k, b=batch: image_batch(k, protos, b, noise=1.0)
    protos = jax.random.normal(key, (10, 32, 32, 3))

    def draw(k, b=batch):
        kx, ky = jax.random.split(k)
        y = jax.random.randint(ky, (b,), 0, 10)
        return protos[y] + 0.5 * jax.random.normal(kx, (b, 32, 32, 3)), y
    return draw


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--data", choices=("bench", "stand_in"), default="bench")
    ap.add_argument("--seed", type=int, default=7,
                    help="the PRNG key of init and data (the benchmark's: 7)")
    ap.add_argument("--lr", type=float, default=CIFAR_HYBRID.learning_rate)
    args = ap.parse_args()
    cfg = dataclasses.replace(CIFAR_HYBRID, learning_rate=args.lr)
    key = jax.random.PRNGKey(args.seed)
    draw = _data(key, args.data, cfg.batch_size)
    img_test, y_test = draw(jax.random.fold_in(key, 1), 1024)
    for variant in ("standard", "sketched_fixed"):
        scfg = SketchConfig(rank=4, max_rank=8, beta=0.9,
                            batch_size=cfg.batch_size, recon_mode="fast")
        kp = jax.random.fold_in(key, 2)
        params = {"stem": conv_stem_init(kp), "mlp": mlp_init(kp, cfg)}
        opt_cfg = AdamWConfig(lr=cfg.learning_rate, b2=0.999)
        opt = init_adamw(params, opt_cfg)
        sk = init_mlp_sketch(kp, cfg, scfg, variant)
        step = _make_step(cfg, scfg, variant, opt_cfg)
        pparams, psk = _port(params, sk)
        pscfg = PortSketchConfig(rank=4, max_rank=8, beta=0.9,
                                 batch_size=cfg.batch_size, recon_mode="fast")
        popt_cfg = PortAdamWConfig(lr=cfg.learning_rate, b2=0.999)
        popt = port_init_adamw(pparams, popt_cfg)
        pstep = make_hybrid_step(
            dataclasses.replace(PORT_CFG, learning_rate=args.lr), pscfg,
            variant, popt_cfg)
        losses, plosses = [], []
        for s in range(args.steps):
            img, y = draw(jax.random.fold_in(key, 100 + s))
            params, opt, sk, loss = step(params, opt, sk, img, y)
            losses.append(float(loss))
            pparams, popt, psk, ploss = pstep(
                pparams, popt, psk, torch.from_numpy(np.array(img)),
                torch.from_numpy(np.array(y)).long())
            plosses.append(float(ploss))
        apart = [s for s, (a, b) in enumerate(zip(plosses, losses))
                 if abs(a - b) > 1e-3 * abs(b)]
        logits = plain_forward(params["mlp"],
                               conv_stem_apply(params["stem"], img_test), cfg)
        acc = float((jnp.argmax(logits, -1) == y_test).mean())
        print(json.dumps({
            "data": args.data, "seed": args.seed, "lr": args.lr,
            "variant": variant,
            "steps": args.steps,
            "loss_first10": statistics.mean(losses[:10]),
            "loss_last10": statistics.mean(losses[-10:]),
            "loss_max": max(losses), "test_acc": acc,
            "port_loss_first10": statistics.mean(plosses[:10]),
            "port_loss_last10": statistics.mean(plosses[-10:]),
            "port_first_step_apart": apart[0] if apart else None}),
            flush=True)


if __name__ == "__main__":
    main()
