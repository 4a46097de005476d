"""Gradient compression (counterpart of ``repro.optim.compression``).

Two modes, selected by ``CompressionConfig.mode``:

  "topk"        per-tensor top-k sparsification with error feedback
                (plain PyTorch; the reference has no kernel for it);
  "countsketch" a linear count-sketch of the flat gradient with error
                feedback and heavy-hitter recovery (SketchedSGD; see
                ``optim.sketched_sgd``), whose table a data-parallel
                wire would merge exactly.

Here the single-worker case; the data-parallel step (``train.step``)
merges the workers' tables, or their dense gradients before top-k.
Shapes are static in both modes.
"""
from __future__ import annotations

import dataclasses
import itertools

import torch

from repro_torch.countsketch.csvec import select_topk
from repro_torch.optim.flat import tree_leaves, tree_like


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    mode: str = "topk"              # "topk" | "countsketch"
    topk_frac: float = 0.05         # fraction of entries transmitted
    int8: bool = True               # quantize transmitted values
    min_k: int = 16
    # count-sketch geometry (mode == "countsketch")
    cs_rows: int = 5                # r hash rows (median-of-r estimate)
    cs_cols: int | None = None      # c buckets per row (power of two);
    #                                 None auto-sizes from the flat dim
    cs_target_ratio: float = 0.05   # auto-size budget: table bytes <=
    #                                 ratio * dense gradient bytes
    cs_k: int = 256                 # heavy hitters recovered per step
    cs_momentum: float = 0.9        # momentum on the sketched residual
    cs_seed: int = 0                # hash-family seed, shared by workers
    cs_p2: int = 0                  # second round: nominate p2*k
    #                                 candidates, then take their exact
    #                                 residual values (0 disables)
    wire_dtype: str = "fp32"        # "fp32" | "int8": precision of the
    #                                 table on the wire (per-row
    #                                 symmetric int8; the quantization
    #                                 error stays in the error feedback)

    def __post_init__(self):
        if self.mode not in ("topk", "countsketch"):
            raise ValueError(
                f"CompressionConfig.mode must be 'topk' or "
                f"'countsketch', got {self.mode!r}")
        if self.wire_dtype not in ("fp32", "int8"):
            raise ValueError(
                f"CompressionConfig.wire_dtype must be 'fp32' or "
                f"'int8', got {self.wire_dtype!r}")
        if self.mode == "countsketch":
            if self.cs_rows < 1:
                raise ValueError(f"cs_rows must be >= 1, got {self.cs_rows}")
            if self.cs_k < 1:
                raise ValueError(f"cs_k must be >= 1, got {self.cs_k}")
            if self.cs_p2 < 0:
                raise ValueError(f"cs_p2 must be >= 0, got {self.cs_p2}")
            if not 0.0 < self.cs_target_ratio < 1.0:
                raise ValueError(
                    f"cs_target_ratio must be in (0, 1), got "
                    f"{self.cs_target_ratio}")
            if self.cs_cols is not None:
                if self.cs_cols < 1 or self.cs_cols & (self.cs_cols - 1):
                    raise ValueError(
                        f"cs_cols must be a power of two, got "
                        f"{self.cs_cols}")


_MIN_COLS = 128        # below this the table is all collisions


#: flat dimensions the count sketch addresses: the reference forms its
#: coordinate indices in int32 (``countsketch/csvec.py``, the top-k's
#: (k,) int32 result), and its step does not trace at 2**31 or more
MAX_FLAT_DIM = 2**31 - 1


def resolve_countsketch(cfg: CompressionConfig, dim: int, *,
                        strict: bool = False) -> CompressionConfig:
    """Pin the count-sketch geometry to the flat parameter dimension.

    ``cs_cols=None`` auto-sizes to the largest power of two keeping the
    (rows x cols) f32 table within ``cs_target_ratio`` of the dense
    gradient bytes, and raises when the model is too small for that.
    ``strict=True`` (``train.state.finalize_run``) also rejects explicit
    geometries that make compression pointless (table >= dense, k >
    dim). A dim past ``MAX_FLAT_DIM`` raises ValueError."""
    if cfg.mode != "countsketch":
        return cfg
    if dim < 1:
        raise ValueError(
            f"countsketch needs a positive flat dim, got {dim}")
    if dim > MAX_FLAT_DIM:
        raise ValueError(
            f"count-sketch compression of a flat gradient of {dim} "
            f"coordinates: the limit is 2**31 - 1 = {MAX_FLAT_DIM} (the "
            f"reference indexes coordinates in int32); cut the model's "
            f"depth or compress without the count sketch")
    cols = cfg.cs_cols
    if cols is None:
        budget = int(dim * cfg.cs_target_ratio) // cfg.cs_rows
        if budget < _MIN_COLS:
            raise ValueError(
                f"cannot auto-size cs_cols: dim={dim} with "
                f"cs_rows={cfg.cs_rows} at target ratio "
                f"{cfg.cs_target_ratio} leaves a per-row budget of "
                f"{budget} < {_MIN_COLS} buckets — the model is too "
                f"small to countsketch-compress; use mode='topk' or "
                f"pass cs_cols explicitly")
        cols = 1 << (budget.bit_length() - 1)
        cfg = dataclasses.replace(cfg, cs_cols=cols)
    if strict:
        if cfg.cs_rows * cols >= dim:
            raise ValueError(
                f"invalid countsketch geometry: table "
                f"{cfg.cs_rows}x{cols} ({cfg.cs_rows * cols} floats) is "
                f"not smaller than the dim={dim} gradient it compresses "
                f"— shrink cs_cols/cs_rows")
        if cfg.cs_k > dim:
            raise ValueError(
                f"cs_k={cfg.cs_k} exceeds the flat dim {dim}")
    return cfg


def init_error_feedback(params, cfg: CompressionConfig | None = None):
    """{u, v} flat accumulators for countsketch, else a zero f32 tree
    shaped like the parameters."""
    if cfg is not None and cfg.mode == "countsketch":
        from repro_torch.optim.sketched_sgd import init_countsketch_state
        return init_countsketch_state(params)
    return tree_like(params, [torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)
                              for p in tree_leaves(params)])


def _compress_one(g, err, cfg: CompressionConfig):
    gf = g.to(torch.float32) + err
    flat = gf.reshape(-1)
    k = max(cfg.min_k, int(flat.shape[0] * cfg.topk_frac))
    k = min(k, flat.shape[0])
    idx = select_topk(flat.abs(), k)
    sel = flat[idx]
    if cfg.int8:
        scale = torch.clamp(sel.abs().max(), min=1e-12) / torch.tensor(
            127.0, device=sel.device)
        q = torch.clamp(torch.round(sel / scale), -127, 127).to(torch.int8)
        sel = q.to(torch.float32) * scale
    sparse = torch.zeros_like(flat)
    sparse[idx] = sel
    new_err = flat - sparse
    return sparse.reshape(g.shape), new_err.reshape(g.shape)


def compress_grads(grads, err_state, cfg: CompressionConfig, *,
                   layout=None, sizes=None):
    """Returns (compressed grads, new error-feedback state, stats).

    Each leaf is compressed on its own; with a ``FlatLayout`` and the
    ``sizes`` of consecutive runs of its flat vector, each run is
    compressed as one tensor instead (the LM passes the reference's
    stacked leaves, ``models.transformer.reference_leaves``)."""
    if layout is None:
        flat_g, flat_e = tree_leaves(grads), tree_leaves(err_state)
    else:
        g, e = layout.ravel(grads), layout.ravel(err_state)
        bounds = [0, *itertools.accumulate(sizes)]
        flat_g = [g[a:b] for a, b in zip(bounds, bounds[1:])]
        flat_e = [e[a:b] for a, b in zip(bounds, bounds[1:])]
    outs = [_compress_one(g, e, cfg) for g, e in zip(flat_g, flat_e)]
    total = sum(g.numel() for g in flat_g)
    sent = sum(max(cfg.min_k, int(g.numel() * cfg.topk_frac))
               for g in flat_g)
    bytes_per = 1 if cfg.int8 else 4
    stats = {"compression_ratio": (sent * (bytes_per + 4)) / (total * 4.0)}
    if layout is None:
        return (tree_like(grads, [o[0] for o in outs]),
                tree_like(grads, [o[1] for o in outs]), stats)
    return (layout.unravel(torch.cat([o[0] for o in outs])),
            layout.unravel(torch.cat([o[1] for o in outs])), stats)


def compressed_bytes(num_params: int, cfg: CompressionConfig) -> int:
    """Bytes a worker would put on the data-parallel wire per step:
    (value, int32 index) pairs for topk; for countsketch the (r, c)
    table (int8 counters and r f32 scales, or f32) plus p2 * k f32
    values of the second round."""
    if cfg.mode == "countsketch":
        if cfg.cs_cols is None:
            cfg = resolve_countsketch(cfg, num_params)
        p2 = cfg.cs_p2 * cfg.cs_k * 4 if cfg.cs_p2 > 0 else 0
        if cfg.wire_dtype == "int8":
            return cfg.cs_rows * cfg.cs_cols * 1 + cfg.cs_rows * 4 + p2
        return cfg.cs_rows * cfg.cs_cols * 4 + p2
    k = int(num_params * cfg.topk_frac)
    return k * ((1 if cfg.int8 else 4) + 4)
