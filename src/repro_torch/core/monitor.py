"""Sketch-based monitoring, paper §4.6 (counterpart of
``repro.core.monitor``).

Every metric is read from the EMA sketches; no gradient or activation
history is stored. Per layer:

  grad_norm_proxy   ||Z_s||_F
  stable_rank       ||Y_s||_F^2 / ||Y_s||_2^2, the spectral norm from the
                    eigenvalues of the k x k Gram matrix
  y_norm            ||Y_s||_F

A ring buffer keeps ``window`` readings of (L, 3) on the device; the
pathology flags read only the buffer. Its write index and count are
host ints, since the host makes every write.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

N_METRICS = 3
METRIC_NAMES = ("grad_norm_proxy", "stable_rank", "y_norm")


def stable_rank(y_s: Tensor, eps: float = 1e-30) -> Tensor:
    """||Y||_F^2 / ||Y||_2^2 of (..., d, k) via the (..., k, k) Gram."""
    g = y_s.transpose(-1, -2) @ y_s
    fro2 = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)
    spec2 = torch.linalg.eigvalsh(g).amax(-1)
    return fro2 / torch.clamp(spec2, min=eps)


def layer_metrics(x_s: Tensor, y_s: Tensor, z_s: Tensor) -> Tensor:
    """(..., N_METRICS) for (..., d, k) triples."""
    return torch.stack([
        torch.linalg.matrix_norm(z_s),
        stable_rank(y_s),
        torch.linalg.matrix_norm(y_s),
    ], dim=-1)


def tree_metrics(tree) -> Tensor:
    """(N, N_METRICS) over every node of a NodeTree, rows in
    ``sketches.node_paths`` order (sorted by node name, layer-major)."""
    mets = []
    for name in sorted(tree.nodes):
        node = tree.nodes[name]
        m = layer_metrics(node.x, node.y, node.z)
        mets.append(m.reshape(-1, N_METRICS))
    return torch.cat(mets, 0)


@dataclasses.dataclass
class MonitorState:
    buffer: Tensor   # (window, L, N_METRICS) f32
    idx: int = 0     # next write slot
    count: int = 0   # total writes


def init_monitor_state(window: int, num_layers: int,
                       device="cpu") -> MonitorState:
    return MonitorState(buffer=torch.zeros((window, num_layers, N_METRICS),
                                           dtype=torch.float32,
                                           device=device))


def monitor_record(state: MonitorState, metrics: Tensor) -> MonitorState:
    """Write one (L, N_METRICS) reading into a copy of the ring."""
    buf = state.buffer.clone()
    buf[state.idx] = metrics.float()
    return MonitorState(buffer=buf, idx=(state.idx + 1) % buf.shape[0],
                        count=state.count + 1)


@dataclasses.dataclass(frozen=True)
class PathologyThresholds:
    vanish_norm: float = 1e-5
    explode_norm: float = 1e6
    stagnation_rel: float = 1e-3     # max relative change over window
    collapse_frac: float = 0.45      # stable rank < frac * k -> collapsed
    min_fill: int = 4                # window-statistic flags stay False
    #                                  until the ring holds this many
    #                                  readings


def detect_pathologies(
    state: MonitorState, k_active: int,
    th: PathologyThresholds = PathologyThresholds(),
) -> dict[str, Tensor]:
    """Boolean (L,) flags per pathology, from the ring buffer only.

    Window statistics (stagnation, diversity collapse) wait for
    ``th.min_fill`` readings; point-in-time flags (vanishing, exploding)
    need one, so an empty ring flags nothing."""
    buf = state.buffer                                   # (W, L, M)
    W = buf.shape[0]
    filled = min(state.count, W)
    n = float(max(filled, 1))
    valid = (torch.arange(W, device=buf.device) < filled)[:, None]
    norms = buf[..., 0]                                  # grad_norm_proxy
    mean_norm = torch.where(valid, norms, 0.0).sum(0) / n
    max_norm = torch.where(valid, norms, -torch.inf).amax(0)
    min_norm = torch.where(valid, norms, torch.inf).amin(0)
    sr = torch.where(valid, buf[..., 1], 0.0).sum(0) / n
    rel_span = (max_norm - min_norm) / torch.clamp(mean_norm, min=1e-30)
    has_data = state.count >= 1
    warmed = state.count >= min(th.min_fill, W)
    return {
        "vanishing": has_data & (mean_norm < th.vanish_norm),
        "exploding": has_data & (max_norm > th.explode_norm),
        "stagnating": warmed & (rel_span < th.stagnation_rel),
        "diversity_collapse": warmed & (sr < th.collapse_frac * k_active),
    }
