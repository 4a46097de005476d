"""The paper's experiment MLPs, §5 (counterpart of ``repro.models.mlp``):
initialisation, activations and the sketch-node registry. Parameters
are a list of {"w" (d_in, d_out), "bias" (d_out,)} dicts, one per linear
layer, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.configs.paper import MLPConfig
from repro_torch.sketches.tree import NodeSpec


def mlp_node_specs(cfg: MLPConfig) -> dict[str, NodeSpec]:
    """One stacked "hidden" node over the hidden activations: node l
    feeds linear layer l+1."""
    return {"hidden": NodeSpec(width=cfg.d_hidden,
                               layers=cfg.num_hidden_layers)}


def _act(name: str):
    return {"tanh": torch.tanh, "relu": torch.relu}[name]


def mlp_init(gen: torch.Generator, cfg: MLPConfig) -> list[dict]:
    """Layers d_in -> d_hidden (x num_hidden_layers) -> d_out, on the
    generator's device; weights drawn layer by layer."""
    dims = [cfg.d_in] + [cfg.d_hidden] * cfg.num_hidden_layers + [cfg.d_out]
    dev = gen.device
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((a, b), generator=gen, device=dev)
        if cfg.init == "kaiming":
            w, bias = w * (2.0 / a) ** 0.5, torch.zeros(b, device=dev)
        elif cfg.init == "xavier_small":
            w = w * 0.5 * (2.0 / (a + b)) ** 0.5
            bias = torch.zeros(b, device=dev)
        elif cfg.init == "kaiming_negbias":
            # paper §5.3 "problematic": strong negative bias b = -3.0
            w, bias = w * (2.0 / a) ** 0.5, torch.full((b,), -3.0, device=dev)
        else:
            raise ValueError(cfg.init)
        params.append({"w": w.to(cfg.dtype), "bias": bias.to(cfg.dtype)})
    return params
