"""Chunkwise stabilised mLSTM forward from a zero state: the CUDA
kernels' wrapper and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/mlstm_chunk.py::
mlstm_chunk``, whose oracle is ``src/repro/models/ssm.py::
_mlstm_chunk_scan``. The kernels are ``csrc/mlstm_chunk.cu`` (CUDA C++
for ``sm_90a``), built at first use by ``kernels._build`` and called
through ``ctypes``.

q and k are (B, H, S, Dk), v (B, H, S, Dv), li and lf (B, H, S) log
gates; S is a multiple of W = min(chunk, S). The result is h (B, H, S,
Dv) f32 and the final state (C (B, H, Dk, Dv), n (B, H, Dk), m (B, H)),
all f32, with every product in f32: q, k and v may be bf16, widened
exactly, as the JAX model widens them before its scan.

Two paths, chosen by ``uses_tensor_cores``:

* bf16 q, k, v at Dk 512, Dv and W multiples of 64, every row 16-byte
  aligned (xlstm-1.3b's serving and refill shapes): the tensor cores.
  q k^T is one exact bf16 product; the f32 operands of the other three
  (C in q C, the masked, decayed scores s in s v, the weighted values
  w v in the C update) are each split into bf16 hi + lo,
  two products into one f32 accumulator (about 2^-17 of |x|; one bf16 or
  TF32 rounding would miss the 1e-4 tolerance). A state block owns a
  (b, h) and 64 value columns and keeps C^T in its accumulator registers
  across the chunks; a scores kernel writes s as hi and lo and each row's
  denominator, a small kernel each chunk's starting n. Bound on an H100
  SXM: W^2 Dk + 2 W^2 Dv + 8 W Dk Dv operations a chunk of a (b, h) (the
  split products counted twice) at 989 TFLOP/s: at the serving shape (B
  8, H 4, S 2048, Dk 512, Dv 1024, W 256) 318 GFLOP, 0.32 ms, against
  0.18 ms of bytes.
* everything else (f32 inputs, narrow or ragged widths): the first
  version's FMA kernels, every product in f32 on the FMA units. Per (b,
  h) and chunk the causal q k^T (W (W + 1) Dk operations), s v (W (W + 1)
  Dv), q C and the C update (2 W Dk Dv each) at 67 TFLOP/s: 2.43 ms at
  the serving shape. The state kernel gives each block one (b, h) and 32
  of its Dv columns, whose C[:, columns] stays in shared memory across
  the loop over chunks; a gates kernel (one block per (b, h)) takes F,
  the sequential in-chunk cumulative sum of lf, the chain of stabilisers
  m over the chunks, the key weights and the chunks' decays; a scores
  kernel (one block per 64 rows of a chunk) takes each row's stabiliser
  mj, the inter-chunk weight and s, into scratch of B H S W floats.

The TPU kernel keeps each (b, h)'s 2 MB state in VMEM across a
sequential chunk axis; a Hopper block has 227 KB, and B H is 4 to 32
against 132 SMs, hence the split over value columns on both paths.

``mlstm_chunk`` takes the plain version for CPU tensors and only for
them; for CUDA tensors it launches the kernels or raises.
``mlstm_chunk.launches`` counts calls that launch, each of which
enqueues the three FMA kernels or the four tensor-core ones.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

W_MAX = 256          # chunk rows the CUDA kernels take at most (csrc)
DK_MAX = 512         # key width the CUDA kernels take at most (csrc)
TC_DK = 512          # key width of the tensor-core path (csrc tc::DK)


def chunk_width(S: int, chunk: int) -> int:
    """W = min(chunk, S); S must be a multiple of it, as the reference
    asserts."""
    if S < 1 or chunk < 1:
        raise ValueError(f"sequence length {S} and chunk {chunk} must be "
                         f"positive")
    W = min(chunk, S)
    if S % W:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"mLSTM chunk {W}: a sequence longer than the chunk "
                         f"must be a whole number of chunks")
    return W


def mlstm_chunk_plain(q: Tensor, k: Tensor, v: Tensor, li: Tensor,
                      lf: Tensor, *, chunk: int = 256):
    """``_mlstm_chunk_scan`` from a zero state in plain PyTorch, in f32:
    (h (B, H, S, Dv), (C, n, m))."""
    B, H, S, Dk = q.shape
    Dv = v.shape[-1]
    W = chunk_width(S, chunk)
    q, k, v, li, lf = (t.float() for t in (q, k, v, li, lf))
    f32 = dict(dtype=torch.float32, device=q.device)
    C = torch.zeros((B, H, Dk, Dv), **f32)
    n = torch.zeros((B, H, Dk), **f32)
    m = torch.zeros((B, H), **f32)
    t = torch.arange(W, device=q.device)
    tri = t[:, None] >= t[None, :]             # j >= t (causal in a chunk)
    scale = Dk ** -0.5
    hs = []
    for c0 in range(0, S, W):
        qj, kj, vj = (x[:, :, c0:c0 + W] for x in (q, k, v))
        lij, lfj = li[..., c0:c0 + W], lf[..., c0:c0 + W]
        F = torch.cumsum(lfj, dim=-1)          # inclusive decay sums
        Ftot = F[..., -1:]
        # intra log weights  w[j,t] = F_j - F_t + li_t   (t <= j)
        wlog = F[..., :, None] - F[..., None, :] + lij[..., None, :]
        wlog = torch.where(tri, wlog, float("-inf"))
        b_inter = F + m[..., None]
        mj = torch.maximum(wlog.amax(dim=-1), b_inter)
        D = torch.exp(wlog - mj[..., None])
        inter = torch.exp(b_inter - mj)
        qs = qj * scale
        s = torch.einsum("bhjd,bhtd->bhjt", qs, kj) * D
        num = s @ vj + inter[..., None] * (qs @ C)
        den = s.sum(dim=-1) + inter * torch.einsum("bhjd,bhd->bhj", qs, n)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-mj))[..., None])
        # carry update
        m_kv = (Ftot - F + lij).amax(dim=-1)
        m_new = torch.maximum(Ftot[..., 0] + m, m_kv)
        wkv = torch.exp(Ftot - F + lij - m_new[..., None])
        decay = torch.exp(Ftot[..., 0] + m - m_new)
        C = decay[..., None, None] * C + torch.einsum(
            "bhtd,bhtv->bhdv", wkv[..., None] * kj, vj)
        n = decay[..., None] * n + torch.einsum("bht,bhtd->bhd", wkv, kj)
        m = m_new
    return torch.cat(hs, dim=2), (C, n, m)


def _check(q: Tensor, k: Tensor, v: Tensor, li: Tensor, lf: Tensor,
           chunk: int) -> int:
    if q.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q, k must be (B, H, S, Dk) and v (B, H, S, Dv); "
                         f"got {tuple(q.shape)}, {tuple(v.shape)}")
    B, H, S, _ = q.shape
    if tuple(k.shape) != tuple(q.shape) or tuple(v.shape[:3]) != (B, H, S):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    for name, t in (("li", li), ("lf", lf)):
        if tuple(t.shape) != (B, H, S):
            raise ValueError(f"{name} must have shape {(B, H, S)}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("k", k), ("v", v), ("li", li), ("lf", lf)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    return chunk_width(S, chunk)


def uses_tensor_cores(q: Tensor, k: Tensor, v: Tensor, chunk: int) -> bool:
    """Whether a CUDA call on these inputs takes the tensor-core kernels:
    bf16 q, k and v, Dk = TC_DK (xlstm's heads; two warpgroups hold C^T's
    halves in registers), Dv and W = min(chunk, S) multiples of 64 (the
    wgmma tiles and the state block's 64 value columns), and
    every row 16-byte aligned (the cp.async copies): each data pointer a
    multiple of 16 bytes and each b/h/s stride a multiple of 8 elements.
    Everything else takes the FMA kernels."""
    S, Dk, Dv = q.shape[2], q.shape[3], v.shape[3]
    W = min(chunk, S)
    return (all(t.dtype == torch.bfloat16 for t in (q, k, v))
            and Dk == TC_DK and Dv % 64 == 0 and W % 64 == 0
            and all(t.data_ptr() % 16 == 0 and t.stride(-1) == 1
                    and all(st % 8 == 0 for st in t.stride()[:3])
                    for t in (q, k, v)))


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mlstm_chunk_launch.argtypes = [p] * 17 + [i] * 8 + [p, f, p]
    lib.mlstm_chunk_launch.restype = i
    lib.mlstm_chunk_error_string.argtypes = [i]
    lib.mlstm_chunk_error_string.restype = ctypes.c_char_p


def mlstm_chunk(q: Tensor, k: Tensor, v: Tensor, li: Tensor, lf: Tensor, *,
                chunk: int = 256):
    """(h, (C, n, m)) as ``mlstm_chunk_plain`` returns them. CPU tensors
    take the plain version; CUDA tensors launch the kernels, which read
    q, k and v (f32 or bf16, one type, unit stride along the last
    dimension) in place."""
    W = _check(q, k, v, li, lf, chunk)
    if q.device.type == "cpu":
        return mlstm_chunk_plain(q, k, v, li, lf, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunk runs on cpu or cuda, not {q.device}")
    B, H, S, Dk = q.shape
    Dv = v.shape[-1]
    if W > W_MAX or Dk > DK_MAX:
        raise ValueError(f"the mlstm_chunk kernels take chunks of at most "
                         f"{W_MAX} rows and Dk at most {DK_MAX}; got W {W}, "
                         f"Dk {Dk}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one type, float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have stride 1 along its last "
                             f"dimension, got strides {t.stride()}")
    li = li.float().contiguous()
    lf = lf.float().contiguous()
    nc = S // W
    f32 = dict(dtype=torch.float32, device=q.device)
    h = torch.empty((B, H, S, Dv), **f32)
    C = torch.empty((B, H, Dk, Dv), **f32)
    n = torch.empty((B, H, Dk), **f32)
    m = torch.empty((B, H), **f32)
    # scratch: F, the key weights, each row's mj (the tensor-core path:
    # its denominator) and inter-chunk weight, each chunk's starting m
    # and decay, the scores s (f32, or bf16 hi and lo in the same bytes)
    # and, on the tensor-core path, each chunk's starting n
    tc = uses_tensor_cores(q, k, v, chunk)
    F, wkv, mj, inter = torch.empty((4, B, H, S), **f32)
    mstart, decay = torch.empty((2, B, H, nc), **f32)
    s = torch.empty((B, H, nc, W, W), **f32)
    nstart = torch.empty((B, H, nc, Dk) if tc else (1,), **f32)
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    lib = _build.load("mlstm_chunk", _bind)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mlstm_chunk_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(),
            lf.data_ptr(), h.data_ptr(), C.data_ptr(), n.data_ptr(),
            m.data_ptr(), F.data_ptr(), wkv.data_ptr(), mstart.data_ptr(),
            decay.data_ptr(), mj.data_ptr(), inter.data_ptr(), s.data_ptr(),
            nstart.data_ptr(), int(q.dtype == torch.bfloat16), int(tc), B,
            H, S, Dk, Dv, W,
            (ctypes.c_longlong * 9)(*strides), Dk ** -0.5, stream)
    if err:
        raise RuntimeError(
            f"mlstm_chunk kernel launch failed: "
            f"{lib.mlstm_chunk_error_string(err).decode()} ({err})")
    mlstm_chunk.launches += 1
    return h, (C, n, m)


mlstm_chunk.launches = 0
