"""The paper's experiment networks, §5 (counterpart of
``repro.models.mlp``): the MLPs (initialisation, activations, forward,
sketch-node registry), the CIFAR hybrid's conv stem, the sketched conv
stem's im2col factoring and the PINN on 2D Poisson. MLP parameters are
a list of {"w" (d_in, d_out), "bias" (d_out,)} dicts, one per linear
layer; images are NHWC and conv weights HWIO, as in the reference. The
convolutions and pools are ``F.conv2d`` and ``F.max_pool2d``: XLA, not
a Pallas kernel, computes them in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.paper import MLPConfig
from repro_torch.sketches.linear import sketched_matmul
from repro_torch.sketches.registry import register_node_specs
from repro_torch.sketches.tree import NodeSpec
from repro_torch.sketches.update import pad_activation_rows, proj_num_tokens

Tensor = torch.Tensor


def mlp_node_specs(cfg: MLPConfig) -> dict[str, NodeSpec]:
    """One stacked "hidden" node over the hidden activations: node l
    feeds linear layer l+1."""
    return {"hidden": NodeSpec(width=cfg.d_hidden,
                               layers=cfg.num_hidden_layers)}


def conv_node_specs(cfg) -> dict[str, NodeSpec]:
    """The sketched conv stem's nodes, one a stage, each as wide as its
    im2col patches (kh*kw*Cin): the feature dim of the factored matmul
    its ``sketched_matmul`` consumes."""
    return {"conv1": NodeSpec(width=3 * 3 * cfg.channels),
            "conv2": NodeSpec(width=3 * 3 * 8)}


register_node_specs("mlp", mlp_node_specs)
register_node_specs("conv", conv_node_specs)


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


def mlp_forward(params, x: Tensor, cfg: MLPConfig):
    """(logits, acts): acts = [A^0, ..., A^{L-1}], the input to each
    linear layer (A^0 = x; hidden activations after the nonlinearity)."""
    act = _act(cfg.activation)
    acts, h, n = [x], x, len(params)
    for i, p in enumerate(params):
        z = h @ p["w"] + p["bias"]
        if i < n - 1:
            h = act(z)
            acts.append(h)
        else:
            h = z
    return h, acts


# -- the CIFAR hybrid's conv stem (paper §5.1.2) ---------------------------


def conv_stem_init(gen: torch.Generator) -> dict:
    """HWIO weights of the two 3x3 convs (3 -> 8 -> 16), c1 drawn first."""
    dev = gen.device
    return {"c1": torch.randn((3, 3, 3, 8), generator=gen, device=dev)
            * (2.0 / 27) ** 0.5,
            "c2": torch.randn((3, 3, 8, 16), generator=gen, device=dev)
            * (2.0 / 72) ** 0.5}


def conv_same(x: Tensor, w: Tensor) -> Tensor:
    """SAME stride-1 conv of NHWC ``x`` with HWIO ``w``, NHWC out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding="same")
    return y.permute(0, 2, 3, 1)


def pool2(h: Tensor) -> Tensor:
    """2x2 stride-2 max-pool of NHWC ``h`` (VALID)."""
    return F.max_pool2d(h.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def conv_stem_apply(p: dict, img: Tensor) -> Tensor:
    """img (B, 32, 32, 3) -> (B, 1024) features (8x8x16, NHWC order)."""
    y = pool2(torch.relu(conv_same(img, p["c1"])))
    y = pool2(torch.relu(conv_same(y, p["c2"])))
    return y.reshape(y.shape[0], -1)


# -- the sketched conv stem: im2col factoring (XConv) ------------------------


def im2col(x: Tensor, kh: int, kw: int) -> Tensor:
    """x (B, H, W, Cin) -> patches (B*H*W, kh*kw*Cin) of a SAME stride-1
    conv, columns in (i, j, c) order, so ``im2col(x) @ w.reshape(-1,
    Cout)`` is the conv with HWIO ``w``."""
    B, H, W, C = x.shape
    ph, pw = kh // 2, kw // 2
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    cols = [xp[:, i:i + H, j:j + W, :] for i in range(kh) for j in range(kw)]
    return torch.cat(cols, dim=-1).reshape(B * H * W, kh * kw * C)


def conv_im2col_sketched(x: Tensor, w: Tensor, node, proj, k_active, *,
                         recon_mode: str, ridge: float, factored: bool,
                         omega: Tensor | None = None) -> Tensor:
    """SAME stride-1 conv through ``sketched_matmul`` on the im2col
    factoring: its backward rebuilds the patch matrix from the stage's
    (already updated) triple instead of storing it; grad_x stays exact.
    Patches are zero-padded to the tree's row binding, so one projection
    serves every stage; padded rows get zero cotangent. ``omega``, the
    materialised (T, k_max) projection, may be passed in when the caller
    has it."""
    B, H, W, _ = x.shape
    kh, kw, _, cout = w.shape
    patches = im2col(x, kh, kw)
    rows = patches.shape[0]
    patches = pad_activation_rows(patches, proj_num_tokens(proj))
    if omega is None:
        omega = proj["omega"]
    y = sketched_matmul(patches, w.reshape(-1, cout).to(patches.dtype),
                        node.x, node.y, node.z, omega, k_active,
                        recon_mode, ridge, factored)
    return y[:rows].reshape(B, H, W, cout)


# -- PINN: 2D Poisson, -Laplace(u) = 8 pi^2 sin(2 pi x) sin(2 pi y) ----------


def poisson_exact(xy: Tensor) -> Tensor:
    return torch.sin(2 * math.pi * xy[..., 0]) * \
        torch.sin(2 * math.pi * xy[..., 1])


def poisson_rhs(xy: Tensor) -> Tensor:
    return 8 * math.pi ** 2 * poisson_exact(xy)


def pinn_scalar(params, cfg: MLPConfig, xy: Tensor) -> Tensor:
    """u(x, y) at one point (2,)."""
    out, _ = mlp_forward(params, xy[None], cfg)
    return out[0, 0]


def pinn_residual(params, cfg: MLPConfig, xy: Tensor) -> Tensor:
    """The PDE residual -Laplace(u) - f at one interior point: exact
    second derivatives, the paper's reason for monitoring-only PINNs."""
    hess = torch.func.hessian(lambda p_: pinn_scalar(params, cfg, p_))(xy)
    return -(hess[0, 0] + hess[1, 1]) - poisson_rhs(xy)


def pinn_loss(params, cfg: MLPConfig, interior: Tensor,
              boundary: Tensor) -> Tensor:
    res = torch.func.vmap(lambda p_: pinn_residual(params, cfg, p_))(interior)
    u_b = torch.func.vmap(lambda p_: pinn_scalar(params, cfg, p_))(boundary)
    return torch.mean(res ** 2) + 10.0 * torch.mean(u_b ** 2)
