"""Configs of the paper's own experiments, §5 (counterpart of
``repro.configs.paper``): MNIST 3x512 tanh, the CIFAR hybrid's 3x512
dense tail, the sketched CIFAR conv stem, PINN 3x50, and the 15x1024
gradient-monitoring pair.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.sketch import SketchConfig


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    name: str
    d_in: int
    d_hidden: int
    d_out: int
    num_hidden_layers: int           # number of hidden (uniform-width) layers
    activation: str = "tanh"         # tanh | relu
    batch_size: int = 128
    learning_rate: float = 1e-3
    optimizer: str = "adam"          # adam | sgd
    init: str = "kaiming"            # kaiming | xavier_small | kaiming_negbias
    dtype: torch.dtype = torch.float32
    # sketching variant: standard | sketched_fixed | sketched_adaptive | monitor
    variant: str = "standard"
    sketch: SketchConfig = SketchConfig()


# §5.1.2 MNIST: four-layer MLP, 512 hidden, tanh, 1.33M params
MNIST_MLP = MLPConfig(
    name="mnist_mlp", d_in=784, d_hidden=512, d_out=10,
    num_hidden_layers=3,   # 784->512, 512->512 x2, 512->10: "four-layer"
    activation="tanh",
)

# §5.1.2 CIFAR-10 hybrid: the conv feature extractor, then three 512-d
# dense layers on its 1024 = 8x8x16 pooled features; sketching applies
# only to this dense tail. The stem is models/mlp.py::conv_stem_apply.
CIFAR_HYBRID = MLPConfig(
    name="cifar_hybrid", d_in=1024, d_hidden=512, d_out=10,
    num_hidden_layers=3, activation="relu",
)


@dataclasses.dataclass(frozen=True)
class ConvConfig:
    """The CIFAR conv stem trained with sketched conv backprop (XConv,
    arXiv:2106.06998): each conv is im2col-factored into a (B*P,
    kh*kw*Cin) @ (kh*kw*Cin, Cout) matmul that ``sketched_matmul``
    consumes."""
    name: str = "cifar_conv"
    hw: int = 32                     # input height = width
    channels: int = 3
    d_out: int = 10
    batch_size: int = 32
    learning_rate: float = 1e-3
    dtype: torch.dtype = torch.float32
    variant: str = "sketched_fixed"  # standard | sketched_fixed
    sketch: SketchConfig = SketchConfig()

    @property
    def num_tokens(self) -> int:
        """The tree's row binding: stage 1's im2col rows, B * hw^2;
        stage 2's B * (hw/2)^2 rows are zero-padded up to it."""
        return self.batch_size * self.hw * self.hw


CIFAR_CONV = ConvConfig()

# §5.1.2 PINN: four-layer, 50-d hidden, 2D Poisson on [0,1]^2
PINN_POISSON = MLPConfig(
    name="pinn_poisson", d_in=2, d_hidden=50, d_out=1,
    num_hidden_layers=3, activation="tanh", batch_size=1024,
    variant="monitor",     # monitoring only: PDE residuals need exact grads
)

# §5.3 gradient-monitoring pair: sixteen-layer, 1024-wide MLPs
MONITOR_HEALTHY = MLPConfig(
    name="monitor_healthy", d_in=784, d_hidden=1024, d_out=10,
    num_hidden_layers=15, activation="relu", init="kaiming",
    optimizer="adam", variant="monitor",
    sketch=SketchConfig(rank=4, beta=0.9),
)

MONITOR_PROBLEMATIC = dataclasses.replace(
    MONITOR_HEALTHY,
    name="monitor_problematic",
    init="kaiming_negbias",   # strong negative bias b=-3.0 (paper §5.3)
    optimizer="sgd",
)

# the launcher's table (launch/paper.py --config)
PAPER_CONFIGS = {c.name: c for c in (MNIST_MLP, CIFAR_HYBRID, CIFAR_CONV,
                                     PINN_POISSON, MONITOR_HEALTHY,
                                     MONITOR_PROBLEMATIC)}
