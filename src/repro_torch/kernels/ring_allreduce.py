"""Quantisation-aware chain all-reduce of W workers' flat f32 buffers:
the CUDA kernel's wrapper and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/ring_allreduce.py::
ring_allreduce`` (a remote-DMA chain between W TPU chips). The port runs
the W data-parallel workers in one process on one card, so the W shard
rows lie side by side in one memory and nothing has to travel: the
kernel computes the chain's result, not its wire. On the fp32 wire that
is one launch, the left fold of the W rows per element; on the int8 wire
one launch a fold point, every chunk's at once, each taking the next
level's per-chunk amax. The kernel is ``csrc/ring_allreduce.cu`` (CUDA
C++ for ``sm_90a``), built at first use by ``kernels._build`` and called
through ``ctypes``; the source file has the design and the bound: the
shards read once, y written once (and the W residual rows on the int8
wire), (4 W + 4) N bytes for the DP step's fp32 call, (8 W + 4) N on the
int8 wire, 4 W N more with ``replicas``.

Semantics are the reference's, bit for bit:

  * chunks of ``_chunk_len(N, W)`` (ceil(N / W) rounded up to 128),
    zero-padded; the pipelined chain, not a rotated ring: chunk c folds
    in device order 0..W-1, so the fp32 wire equals the left fold
    ``x[0] + x[1] + ... + x[W-1]`` (the reference's psum order) exactly;
  * int8 wire: each fold point requantises the running sum per chunk,
    symmetric, round half to even, and keeps ``s - dequant(q)`` in that
    device's residual row; the broadcast forwards the raw (int8, scale)
    pairs, so every replica dequantises the same bits. The arithmetic is
    that of the reference's compiled oracle (XLA:CPU rewrites the
    source's expressions inside its ``fori_loop``): scale =
    amax * fl(1/127), q = rint(s / safe) by a true division, the fold
    ``s = fma(q, sc, x)`` and the residual ``fma(-q, sc, s)``. The plain
    version computes each FMA in float64 and rounds once to f32 (the
    product of an int8 code and an f32 scale is exact in float64), which
    is the FMA unless the float64 sum itself rounds, at an exponent gap
    of more than 21 bits between x and the running sum.

The mass-conservation ledger ``dequant(y) + sum_d res_d == sum_d x_d``
holds to ulp scale.

``ring_allreduce`` takes the plain version for CPU tensors and only for
them; for CUDA tensors it launches the kernels or raises.
``ring_allreduce.launches`` counts the calls that launched on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

QMAX = 127.0
LANE = 128
WIRE_DTYPES = ("fp32", "int8")
# fl(1/127) in f32, as the compiled oracle multiplies by it
RECIP_QMAX = float(torch.tensor(1.0) / torch.tensor(QMAX))


def _chunk_len(n: int, workers: int) -> int:
    s = -(-n // workers)
    return -(-s // LANE) * LANE


def kernels_per_call(workers: int, wire_dtype: str) -> int:
    """Ring kernels one call launches on the card: the fold on the fp32
    wire (beside PyTorch's fill of the 0-d zero its residual view
    expands); the level-0 amax and one launch a fold point on the int8
    wire (after a memset); none for one worker."""
    if workers <= 1:
        return 0
    return 1 if wire_dtype == "fp32" else workers + 1


def ring_wire_bytes(n: int, workers: int, wire_dtype: str) -> int:
    """Bytes one device sends through the ring for an n-element vector:
    3W - 3 hops of one chunk each (payload and, on the int8 wire, one f32
    scale)."""
    if workers <= 1:
        return 0
    s = _chunk_len(n, workers)
    hops = 3 * workers - 3
    if wire_dtype == "int8":
        return hops * (s + 4)
    return hops * s * 4


def _check(xs: Tensor, wire_dtype: str) -> tuple[int, int]:
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"unsupported wire_dtype {wire_dtype!r}")
    if xs.dim() != 2 or xs.dtype != torch.float32:
        raise ValueError(f"ring_allreduce takes (W, N) float32 shards, got "
                         f"{tuple(xs.shape)} {xs.dtype}")
    return xs.shape


def fma_f32(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """round_f32(a * b + c) through float64, where the product is exact
    for an int8 code and an f32 scale."""
    return (a.double() * b.double() + c.double()).float()


def quant_rows(s: Tensor) -> tuple[Tensor, Tensor]:
    """Symmetric int8 codes (as f32) and scales (..., 1) of each
    trailing-axis row of ``s``, in the compiled oracle's arithmetic:
    scale = amax * fl(1/127), codes rint(s / scale) by a true division."""
    amax = s.abs().amax(dim=-1, keepdim=True)
    scale = amax * RECIP_QMAX
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(s / safe), -QMAX, QMAX)
    return q, scale


def ring_allreduce_plain(xs: Tensor, wire_dtype: str = "fp32"
                         ) -> tuple[Tensor, Tensor]:
    """The plain version (``repro.kernels.ring_allreduce.
    ring_allreduce_ref``): ``(y (N,), res (W, N))`` of the stacked
    shards, the fold in device order and each device's residual row (a
    zero view on the fp32 wire)."""
    W, N = _check(xs, wire_dtype)
    if W == 1:
        return xs[0].clone(), torch.zeros_like(xs)
    if wire_dtype == "fp32":   # element-wise: the chunks change nothing
        y = xs[0].clone()
        for d in range(1, W):
            y += xs[d]
        return y, xs.new_zeros(()).expand(W, N)
    S = _chunk_len(N, W)
    xp = xs.new_zeros((W, W * S))
    xp[:, :N] = xs
    xp = xp.view(W, W, S)                     # [device, chunk, lane]
    res = torch.zeros_like(xp)
    q, sc = quant_rows(xp[0])
    res[0] = fma_f32(-q, sc, xp[0])
    for d in range(1, W):
        s = fma_f32(q, sc, xp[d])
        q, sc = quant_rows(s)
        res[d] = fma_f32(-q, sc, s)
    y = q * sc
    return y.reshape(-1)[:N], res.reshape(W, -1)[:, :N]


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ring_allreduce_launch.argtypes = [p] * 5 + [ctypes.c_longlong, i, i,
                                                    i, i, p]
    lib.ring_allreduce_launch.restype = i
    lib.ring_allreduce_error_string.argtypes = [i]
    lib.ring_allreduce_error_string.restype = ctypes.c_char_p


def ring_allreduce(xs: Tensor, wire_dtype: str = "fp32", *,
                   replicas: bool = False) -> tuple[Tensor, Tensor]:
    """All-reduce the W stacked (W, N) f32 shards ``xs`` through the
    chain. Returns ``(y, res)``: device 0's replica of the merged vector
    (N,), or with ``replicas`` every device's (W, N), and the (W, N)
    per-device residual ledgers (a zero view on the fp32 wire). W == 1
    returns the shard and zeros and launches nothing. CPU tensors take
    the plain version; CUDA tensors launch the kernels."""
    W, N = _check(xs, wire_dtype)
    if W == 1 or xs.device.type == "cpu":
        y, res = ring_allreduce_plain(xs, wire_dtype)
        return (y.expand(W, N).clone() if replicas else y), res
    if xs.device.type != "cuda":
        raise ValueError(f"ring_allreduce runs on cpu or cuda, not "
                         f"{xs.device}")
    xs = xs.contiguous()
    if xs.data_ptr() % 16:     # the kernel's 16-byte loads need an aligned base
        xs = xs.clone()
    lib = _build.load("ring_allreduce", _bind)
    dev = xs.device
    S = _chunk_len(N, W)
    int8 = wire_dtype == "int8"
    y = torch.empty((W if replicas else 1, N), dtype=torch.float32,
                    device=dev)
    if int8:
        res = torch.empty((W, N), dtype=torch.float32, device=dev)
        codes = torch.empty((W * S,), dtype=torch.int8, device=dev)
        amax = torch.empty((W * W,), dtype=torch.int32, device=dev)
        ptrs = res.data_ptr(), codes.data_ptr(), amax.data_ptr()
    else:
        res = xs.new_zeros(()).expand(W, N)
        ptrs = None, None, None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ring_allreduce_launch(
            xs.data_ptr(), y.data_ptr(), *ptrs, N, W, S, int(int8),
            int(replicas), stream)
    if err:
        raise RuntimeError(
            f"ring_allreduce kernel launch failed: "
            f"{lib.ring_allreduce_error_string(err).decode()} ({err})")
    ring_allreduce.launches += 1
    return (y if replicas else y[0]), res


ring_allreduce.launches = 0
