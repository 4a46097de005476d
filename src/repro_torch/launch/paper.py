"""Paper MLP trainer launcher: the quickstart and gradient-monitoring
examples of the JAX package, on synthetic class prototypes.

    PYTHONPATH=src python -m repro_torch.launch.paper --config mnist_mlp \\
        --variant sketched_fixed --proj-kind psparse --steps 200 \\
        [--device cpu]

Runs on the CUDA device unless ``--device`` names another, and raises
without one. Prints the loss every ``--log-every`` steps, the final test
accuracy and, for the sketch-keeping variants, the pathology flags the
monitor reads from the sketches alone. ``--config`` takes the
classification configs: mnist_mlp, cifar_hybrid (its dense tail on
1024-d features), monitor_healthy and monitor_problematic. Each config
fixes its sketch settings and data noise as the JAX package's runs do:
the monitoring pair as examples/gradient_monitoring.py, the others as
benchmarks/bench_mnist.py.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.paper import PAPER_CONFIGS
from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.core.monitor import detect_pathologies
from repro_torch.core.sketch import PROJ_KINDS, SketchConfig
from repro_torch.data.synthetic import class_prototypes, classification_batch
from repro_torch.device import resolve_device
from repro_torch.sketches import node_paths
from repro_torch.telemetry import flag_paths
from repro_torch.train.paper_trainer import VARIANTS, PaperTrainResult, \
    accuracy, train

MONITOR_PAIR = ("monitor_healthy", "monitor_problematic")
CONFIGS = ("mnist_mlp", "cifar_hybrid") + MONITOR_PAIR
SEED = 0


def run_settings(config: str, batch_size: int, proj_kind: str):
    """(SketchConfig, data noise) of a config's runs in the JAX package."""
    if config in MONITOR_PAIR:
        return SketchConfig(rank=4, max_rank=8, beta=0.9,
                            batch_size=batch_size, proj_kind=proj_kind), 2.0
    return SketchConfig(rank=2, max_rank=16, beta=0.95, batch_size=batch_size,
                        recon_mode="fast", proj_kind=proj_kind), 1.2


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
    protos = class_prototypes(gen, cfg.d_out, cfg.d_in)
    x_test, y_test = classification_batch(gen, protos, 1024, noise)

    def batch_fn(step):
        return classification_batch(gen, protos, cfg.batch_size, noise)

    def eval_fn(params):
        return {"test_acc": accuracy(params, cfg, x_test, y_test)}

    t0 = time.perf_counter()
    res = train(cfg, scfg, args.variant, steps=args.steps, batch_fn=batch_fn,
                eval_fn=eval_fn, seed=SEED,
                adaptive=AdaptiveConfig(r0=scfg.rank, r_max=scfg.max_rank),
                device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    for rec in res.history:
        if (rec["step"] + 1) % args.log_every == 0:
            print(f"step {rec['step'] + 1:5d} loss {rec['loss']:.4f} "
                  f"rank {rec['rank']}")
    print(f"{cfg.name} {args.variant} ({args.proj_kind}) on {device}: "
          f"{args.steps} steps in {dt:.2f}s, final loss "
          f"{res.history[-1]['loss']:.4f}, test acc {eval_fn(res.params)['test_acc']:.3f}")
    if args.variant != "standard":
        k = 2 * int(res.sketch.rank) + 1
        flags = flag_paths(detect_pathologies(res.monitor, k),
                           node_paths(res.sketch))
        print("pathology flags: " + (", ".join(
            f"{name}: {len(paths)} layer(s)"
            for name, paths in sorted(flags.items())) or "none"))
    return res


if __name__ == "__main__":
    main()
