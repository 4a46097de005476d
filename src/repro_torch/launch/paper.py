"""Launcher of the paper's experiments on synthetic data: the MLPs, the
CIFAR hybrid (conv stem + dense tail), the sketched CIFAR conv stem and
the PINN.

    PYTHONPATH=src python -m repro_torch.launch.paper --config mnist_mlp \\
        --variant sketched_fixed --proj-kind psparse --steps 200 \\
        [--device cpu]

Runs on the CUDA device unless ``--device`` names another, and raises
without one. Prints the loss every ``--log-every`` steps and a summary
line. ``--config``:

  mnist_mlp, monitor_healthy, monitor_problematic  the MLP trainer on
      class prototypes; any ``--variant``; the final test accuracy and,
      for the sketch-keeping variants, the pathology flags the monitor
      reads from the sketches alone;
  cifar_hybrid  the conv stem (exact gradients) and the dense tail (the
      variant's) trained together on 32x32x3 images;
  cifar_conv    the sketched conv stem (``--variant sketched_fixed``,
      or ``standard``) on the conv family's stand-in CIFAR batches
      (``fake_cifar_batch``);
  pinn_poisson  the PINN on 2D Poisson, ``--variant monitor`` (the
      monitor's sketches on) or ``standard`` (off); prints the L2
      relative error against the exact solution.

Each config fixes its sketch settings and data noise as the JAX
package's runs do (``run_settings``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.paper import PAPER_CONFIGS
from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.monitor import detect_pathologies
from repro_torch.core.sketch import PROJ_KINDS, SketchConfig
from repro_torch.data.synthetic import (
    cifar_prototypes, class_prototypes, classification_batch,
    fake_cifar_batch, image_batch, pinn_points,
)
from repro_torch.device import resolve_device
from repro_torch.models.mlp import conv_stem_init, mlp_init
from repro_torch.sketches import node_paths
from repro_torch.telemetry import flag_paths
from repro_torch.train.paper_trainer import (
    VARIANTS, PaperTrainResult, accuracy, hybrid_accuracy, l2_rel_error,
    train, train_conv, train_hybrid, train_pinn,
)

MONITOR_PAIR = ("monitor_healthy", "monitor_problematic")
CONFIGS = ("mnist_mlp", "cifar_hybrid", "cifar_conv", "pinn_poisson") \
    + MONITOR_PAIR
SEED = 0
PINN_BOUNDARY = 256


def run_settings(config: str, batch_size: int, proj_kind: str):
    """(SketchConfig, data noise) of a config's runs in the JAX package:
    the monitoring pair as examples/gradient_monitoring.py, the hybrid
    as benchmarks/bench_cifar_hybrid.py, the PINN as
    benchmarks/bench_pinn.py, the conv stem at ConvConfig's own sketch
    settings on the reference's conv-family data (``fake_cifar_batch``,
    noise 0.5), mnist_mlp as benchmarks/bench_mnist.py."""
    if config in MONITOR_PAIR:
        return SketchConfig(rank=4, max_rank=8, beta=0.9,
                            batch_size=batch_size, proj_kind=proj_kind), 2.0
    if config == "cifar_hybrid":
        return SketchConfig(rank=4, max_rank=8, beta=0.9,
                            batch_size=batch_size, recon_mode="fast",
                            proj_kind=proj_kind), 1.0
    if config == "pinn_poisson":
        return SketchConfig(rank=2, max_rank=8, beta=0.95,
                            batch_size=batch_size, proj_kind=proj_kind), None
    if config == "cifar_conv":
        return dataclasses.replace(PAPER_CONFIGS[config].sketch,
                                   proj_kind=proj_kind), 0.5
    return SketchConfig(rank=2, max_rank=16, beta=0.95, batch_size=batch_size,
                        recon_mode="fast", proj_kind=proj_kind), 1.2


def _image_data(gen, cfg, noise: float, hw: int = 32, ch: int = 3):
    protos = class_prototypes(gen, cfg.d_out, hw * hw * ch)
    test = image_batch(gen, protos, 1024, hw, ch, noise)
    return (lambda step: image_batch(gen, protos, cfg.batch_size, hw, ch,
                                     noise)), test


def main(argv=None) -> PaperTrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="mnist_mlp", choices=CONFIGS)
    ap.add_argument("--variant", default="sketched_fixed", choices=VARIANTS)
    ap.add_argument("--proj-kind", default="gaussian", choices=PROJ_KINDS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = PAPER_CONFIGS[args.config]
    scfg, noise = run_settings(args.config, cfg.batch_size, args.proj_kind)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 100)
    summary = ""
    t0 = time.perf_counter()
    if args.config == "cifar_conv":
        if args.variant not in ("standard", "sketched_fixed"):
            raise ValueError("cifar_conv trains standard or sketched_fixed")
        protos = cifar_prototypes(gen, cfg.d_out, cfg.hw, cfg.channels)
        res = train_conv(cfg, scfg, args.variant, steps=args.steps,
                         batch_fn=lambda step: fake_cifar_batch(
                             gen, protos, cfg.batch_size, noise),
                         seed=SEED, device=device)
    elif args.config == "pinn_poisson":
        if args.variant not in ("standard", "monitor"):
            raise ValueError("pinn_poisson trains with the monitor "
                             "(--variant monitor) or without (standard)")
        res = train_pinn(cfg, scfg, steps=args.steps, points_fn=lambda s:
                         pinn_points(gen, cfg.batch_size, PINN_BOUNDARY),
                         monitor=args.variant == "monitor", seed=SEED,
                         device=device)
        summary = f", L2 relative error {l2_rel_error(res.params, cfg):.4f}"
    elif args.config == "cifar_hybrid":
        batch_fn, test = _image_data(gen, cfg, noise)
        pgen = torch.Generator(device=device).manual_seed(SEED)
        params = {"stem": conv_stem_init(pgen), "mlp": mlp_init(pgen, cfg)}
        res = train_hybrid(cfg, scfg, args.variant, steps=args.steps,
                           batch_fn=batch_fn, params=params, seed=SEED,
                           device=device)
        summary = (f", test acc "
                   f"{hybrid_accuracy(res.params, cfg, *test):.3f}")
    else:
        protos = class_prototypes(gen, cfg.d_out, cfg.d_in)
        x_test, y_test = classification_batch(gen, protos, 1024, noise)

        def eval_fn(params):
            return {"test_acc": accuracy(params, cfg, x_test, y_test)}

        res = train(cfg, scfg, args.variant, steps=args.steps,
                    batch_fn=lambda step: classification_batch(
                        gen, protos, cfg.batch_size, noise),
                    eval_fn=eval_fn, seed=SEED,
                    adaptive=AdaptiveConfig(r0=scfg.rank, r_max=scfg.max_rank),
                    device=device)
        summary = f", test acc {eval_fn(res.params)['test_acc']:.3f}"
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    for rec in res.history:
        if (rec["step"] + 1) % args.log_every == 0:
            print(f"step {rec['step'] + 1:5d} loss {rec['loss']:.4f}")
    print(f"{cfg.name} {args.variant} ({args.proj_kind}) on {device}: "
          f"{args.steps} steps in {dt:.2f}s, final loss "
          f"{res.history[-1]['loss']:.4f}{summary}")
    if res.monitor is not None and args.variant != "standard":
        k = 2 * int(res.sketch.rank) + 1
        flags = flag_paths(detect_pathologies(res.monitor, k),
                           node_paths(res.sketch))
        print("pathology flags: " + (", ".join(
            f"{name}: {len(paths)} layer(s)"
            for name, paths in sorted(flags.items())) or "none"))
    return res


if __name__ == "__main__":
    main()
