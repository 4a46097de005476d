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

The gradient: ``mlstm_chunk_train`` is ``mlstm_chunk`` as an autograd
Function that saves q, k, v, li, lf and h (no state: the chunk-start
states would take B H (S / W) Dk Dv floats, 21 GiB over xlstm's 42
layers at B 8 x S 2048) and whose backward is ``mlstm_chunk_bwd``:
``csrc/mlstm_chunk_bwd.cu`` on the card (it recomputes the states into
scratch and sweeps the chunks in reverse, carrying dC and dn), on the
tensor cores where ``uses_tensor_cores`` holds (nine kernels, every f32
operand split into bf16 hi + lo; ``mlstm_chunk_bwd_tc_emulate`` repeats
their roundings in plain PyTorch) and on six FMA kernels otherwise;
``mlstm_chunk_bwd_plain`` on the CPU. The reference has no Pallas
backward; it takes jax.grad of its scan.
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


def mlstm_chunk_bwd_plain(q: Tensor, k: Tensor, v: Tensor, li: Tensor,
                          lf: Tensor, h: Tensor, dh: Tensor, *,
                          chunk: int = 256):
    """The gradient of ``mlstm_chunk_plain``'s h in plain PyTorch, in
    f32, by the kernel's algorithm: the chunk-start states recomputed,
    then one reverse sweep over the chunks carrying dC and dn. h is the
    forward's output, dh its gradient; C, n and m carry none. Returns
    (dq, dk, dv) in q's, k's and v's types and (dli, dlf) in f32.

    The stabilisers m are constants: h = num / max(|den|, exp(-m_j)) is
    the unstabilised num over max(|den|, 1), whatever m is, so the paths
    through m, its max and amax sum to zero. With P = (scale q) k^T, D
    the decayed mask exp(wlog - m_j), S = P * D, e_j = exp(F_j + m - m_j)
    the inter-chunk weight, M_j the denominator and a_j its first branch:
        dnum_j = dh_j / M_j,  dden_j = -a_j sign(den_j) (dh_j . h_j) / M_j
        dS = dnum v^T + dden,  dP = dS * D,  dwlog = dS * S
    and the state terms (C_c, n_c the chunk's start, dC, dn the gradient
    of its end, g its decay, w the key weights):
        dq  = scale (dP k + e (C_c dnum + dden n_c))
        dk  = dP^T (scale q) + w (dC v + dn)
        dv  = S^T dnum + w (k dC)
        dC_c = g dC + (e scale q)^T dnum,  dn_c = g dn + (e dden scale q)
    dF gathers dwlog's row sums less its column sums, de e, -dw w and, at
    the chunk's last row, dg g + sum dw w; dli = dwlog's column sums +
    dw w; dlf is the reversed in-chunk cumulative sum of dF."""
    return _bwd(q, k, v, li, lf, h, dh, chunk, _exact_prod, _kept)


def mlstm_chunk_bwd_tc_emulate(q: Tensor, k: Tensor, v: Tensor, li: Tensor,
                               lf: Tensor, h: Tensor, dh: Tensor, *,
                               chunk: int = 256):
    """``mlstm_chunk_bwd_plain`` with the tensor-core kernels' roundings,
    in plain PyTorch (for tests and tools; the main path never calls it):
    each f32 operand of a product split into bf16 hi + lo where the
    kernels split it (``_prod``), and S, scale dP, C_c and dC kept as
    hi + lo where the kernels keep them in scratch (``_stored``); q, k
    and v are bf16 values, exact."""
    return _bwd(q, k, v, li, lf, h, dh, chunk, _prod, _stored)


def _exact_prod(a: Tensor, b: Tensor, split_a: bool, split_b: bool,
                name: str) -> Tensor:
    return a @ b


def _kept(x: Tensor) -> Tensor:
    return x


def _split(x: Tensor) -> tuple[Tensor, Tensor]:
    """(hi, lo) = (bf16(x), bf16(x - hi)) in f32, as the kernels'
    ``split2`` carries an f32 operand: hi + lo is x to about 2^-17."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _prod(a: Tensor, b: Tensor, split_a: bool, split_b: bool,
          name: str) -> Tensor:
    """a @ b as the tensor-core kernels run it: each split operand as hi +
    lo, the products hi hi + hi lo + lo hi where both are split (lo lo
    dropped), hi b + lo b where only a is (b exact in bf16). ``name``
    says which product: "states" (w v)^T k, "dnum_v" dnum v^T, "sweep"
    (e scale dnum)^T q, "dnum_c" dnum C_c^T, "dnum_s" dnum^T S."""
    ah, al = _split(a) if split_a else (a, None)
    bh, bl = _split(b) if split_b else (b, None)
    out = ah @ bh
    if bl is not None:
        out = out + ah @ bl
    if al is not None:
        out = out + al @ bh
    return out


def _stored(x: Tensor) -> Tensor:
    """x as the kernels keep it in scratch: bf16 hi + lo."""
    hi, lo = _split(x)
    return hi + lo


def _bwd(q: Tensor, k: Tensor, v: Tensor, li: Tensor, lf: Tensor, h: Tensor,
         dh: Tensor, chunk: int, prod, stored):
    """The backward's algorithm, each product of an f32 operand through
    ``prod`` (a, b, whether a is split, whether b is, its name) and each
    value the kernels keep in scratch through ``stored``."""
    B, H, S, Dk = q.shape
    Dv = v.shape[-1]
    W = chunk_width(S, chunk)
    dts = (q.dtype, k.dtype, v.dtype)
    q, k, v, li, lf, h, dh = (t.float() for t in (q, k, v, li, lf, h, dh))
    f32 = dict(dtype=torch.float32, device=q.device)
    t = torch.arange(W, device=q.device)
    tri = t[:, None] >= t[None, :]
    scale = Dk ** -0.5
    # the forward's gates and chunk-start states, recomputed
    C = torch.zeros((B, H, Dk, Dv), **f32)
    n = torch.zeros((B, H, Dk), **f32)
    m = torch.zeros((B, H), **f32)
    fwd = []
    for c0 in range(0, S, W):
        kj, vj = k[:, :, c0:c0 + W], v[:, :, c0:c0 + W]
        lij = li[..., c0:c0 + W]
        F = torch.cumsum(lf[..., c0:c0 + W], dim=-1)
        Ftot = F[..., -1:]
        wlog = F[..., :, None] - F[..., None, :] + lij[..., None, :]
        wlog = torch.where(tri, wlog, float("-inf"))
        mj = torch.maximum(wlog.amax(dim=-1), F + m[..., None])
        m_new = torch.maximum(Ftot[..., 0] + m,
                              (Ftot - F + lij).amax(dim=-1))
        wkv = torch.exp(Ftot - F + lij - m_new[..., None])
        decay = torch.exp(Ftot[..., 0] + m - m_new)
        fwd.append(dict(F=F, D=torch.exp(wlog - mj[..., None]), mj=mj,
                        inter=torch.exp(F + m[..., None] - mj), wkv=wkv,
                        decay=decay, C=stored(C), n=n))
        # C^T = decay C^T + (w v)^T k
        C = decay[..., None, None] * C + prod(
            (wkv[..., None] * vj).mT, kj, True, False, "states").mT
        n = decay[..., None] * n + torch.einsum("bht,bhtd->bhd", wkv, kj)
        m = m_new
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    dli, dlf = torch.empty_like(li), torch.empty_like(lf)
    dC = torch.zeros((B, H, Dk, Dv), **f32)
    dn = torch.zeros((B, H, Dk), **f32)
    for c in reversed(range(len(fwd))):
        g = fwd[c]
        sl = slice(c * W, (c + 1) * W)
        qj, kj, vj = q[:, :, sl], k[:, :, sl], v[:, :, sl]
        S_ = torch.where(tri, (qj @ kj.mT) * scale * g["D"], 0.0)
        qn = scale * torch.einsum("bhjd,bhd->bhj", qj, g["n"])
        den = S_.sum(dim=-1) + g["inter"] * qn
        floor = torch.exp(-g["mj"])
        M = torch.maximum(den.abs(), floor)
        delta = (dh[:, :, sl] * h[:, :, sl]).sum(dim=-1)
        dnum = dh[:, :, sl] / M[..., None]
        dden = torch.where(den.abs() >= floor, -torch.sign(den) * delta / M,
                           torch.zeros_like(den))
        dS = torch.where(tri, prod(dnum, vj.mT, True, False, "dnum_v")
                         + dden[..., None], 0.0)
        S_s = stored(S_)
        dPs = stored(dS * g["D"] * scale)              # scale dP
        dwlog = dS * S_s
        dC_s = stored(dC)
        u = prod(dnum, g["C"].mT, True, True, "dnum_c")     # C_c dnum_j
        r = vj @ dC_s.mT + dn[:, :, None]              # dC v_t + dn
        e, w = g["inter"], g["wkv"]
        dq[:, :, sl] = dPs @ kj + (scale * e)[..., None] * (
            u + dden[..., None] * g["n"][:, :, None])
        dk[:, :, sl] = dPs.mT @ qj + w[..., None] * r
        dv[:, :, sl] = (w[..., None] * (kj @ dC_s)
                        + prod(dnum.mT, S_s, True, True, "dnum_s").mT)
        dinter = ((qj * scale) * (u + dden[..., None]
                                  * g["n"][:, :, None])).sum(dim=-1)
        dwkv = (kj * r).sum(dim=-1)
        dg = (dC * g["C"]).sum(dim=(-2, -1)) + (dn * g["n"]).sum(dim=-1)
        cols = dwlog.sum(dim=-2)
        dF = dwlog.sum(dim=-1) - cols + dinter * e - dwkv * w
        dF[..., -1] += dg * g["decay"] + (dwkv * w).sum(dim=-1)
        dli[..., sl] = cols + dwkv * w
        dlf[..., sl] = torch.flip(torch.cumsum(torch.flip(dF, [-1]), -1),
                                  [-1])
        # dC^T = decay dC^T + (e scale dnum)^T q
        dC = g["decay"][..., None, None] * dC + prod(
            ((e * scale / M)[..., None] * dh[:, :, sl]).mT, qj, True, False,
            "sweep").mT
        dn = g["decay"][..., None] * dn + scale * torch.einsum(
            "bhj,bhjd->bhd", e * dden, qj)
    return dq.to(dts[0]), dk.to(dts[1]), dv.to(dts[2]), dli, dlf


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


BWD_TOL = 1e-4       # the backward kernels against their plain version


def bwd_gap(got: Tensor, want: Tensor, tol: float = BWD_TOL) -> float:
    """The largest share of the backward check's allowance that ``got``
    uses against the plain version's f32 gradient ``want`` (of the same
    inputs widened exactly): rtol ``tol`` and atol ``tol`` * max|want|,
    and for a bf16 ``got`` its one rounding, 2^-8 |want|. At most 1
    passes; a NaN or inf where ``want`` is finite counts as inf."""
    w, g = want.float(), got.float()
    allow = tol * (w.abs().max() + w.abs())
    if got.dtype == torch.bfloat16:
        allow = allow + 2.0 ** -8 * w.abs()
    return float(((g - w).abs() / allow).nan_to_num(float("inf")).max())


def mlstm_bwd_flops(B: int, H: int, S: int, Dk: int, Dv: int,
                    W: int) -> int:
    """Operations of one backward call, as the kernels count them: per
    chunk of a (b, h), the causal products (scale q) k^T, dnum v^T,
    S^T dnum, dP k and dP^T q, W (W + 1) (3 Dk + 2 Dv), and the five
    state products (C_c dnum, dC v, k dC, the dC update and the
    recomputed C update), 10 W Dk Dv."""
    return B * H * (S // W) * (W * (W + 1) * (3 * Dk + 2 * Dv)
                               + 10 * W * Dk * Dv)


def mlstm_bwd_tc_flops(B: int, H: int, S: int, Dk: int, Dv: int,
                       W: int) -> int:
    """Operations of one backward call on the tensor-core path, as its
    kernels issue them: each split product counted twice (one operand
    exact in bf16) or three times (both split), the scores and dv blocks
    over all 256 keys of their m64n256 tiles, dP k and dP^T q over the
    causal 64-row blocks, and the states and sweep over every chunk but
    the last one each walks. The design's own work, about twice
    ``mlstm_bwd_flops``, the function's, which bounds the call."""
    nc, R, N = S // W, W // 64, 256
    chain = 2 * (nc - 1) * 2 * 2 * W * Dk * Dv    # (w v)^T k, (e dnum)^T q
    per_chunk = (2 * W * N * Dk                   # q k^T
                 + 2 * 2 * W * N * Dv             # dnum v^T
                 + 3 * 2 * W * Dk * Dv            # dnum C_c^T
                 + 2 * 2 * W * Dk * Dv            # v dC^T
                 + 2 * 2 * 2 * 64 * 64 * Dk * R * (R + 1) // 2  # dP k, dP^T q
                 + 2 * 2 * Dv * N * Dk            # dC^T k^T
                 + 3 * 2 * Dv * N * W)            # dnum^T S
    return B * H * (chain + nc * per_chunk)


def _bind_bwd(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mlstm_chunk_bwd_workspace.argtypes = [i] * 7
    lib.mlstm_chunk_bwd_workspace.restype = ctypes.c_longlong
    lib.mlstm_chunk_bwd_launch.argtypes = (
        [p] * 13 + [i] * 8 + [p, ctypes.c_float, p])
    lib.mlstm_chunk_bwd_launch.restype = i
    lib.mlstm_chunk_bwd_error_string.argtypes = [i]
    lib.mlstm_chunk_bwd_error_string.restype = ctypes.c_char_p


def mlstm_chunk_bwd(q: Tensor, k: Tensor, v: Tensor, li: Tensor, lf: Tensor,
                    h: Tensor, dh: Tensor, *, chunk: int = 256):
    """(dq, dk, dv, dli, dlf) as ``mlstm_chunk_bwd_plain`` returns them,
    each contiguous. CPU tensors take the plain version; CUDA tensors
    launch the kernels of ``csrc/mlstm_chunk_bwd.cu``, which read q, k
    and v (one type, f32 or bf16, unit stride along the last dimension)
    in place and h and dh as f32: the nine tensor-core kernels where
    ``uses_tensor_cores`` holds, the six FMA kernels otherwise.

    Bound on an H100 SXM, at xlstm's train shape (B 4, H 4, S 512, Dk
    512, Dv 1024, W 256), against 0.04 ms of bytes (bf16 q, k, v read and
    dq, dk, dv written once, f32 h, dh, li, lf, dli, dlf: 134 MB): on the
    tensor cores ``mlstm_bwd_tc_flops`` at 989 TFLOP/s, 106.3 GFLOP, 0.11
    ms; on the FMA units ``mlstm_bwd_flops`` at 67 TFLOP/s, B H (S / W)
    (W (W + 1) (3 Dk + 2 Dv) + 10 W Dk Dv) operations, 50.5 GFLOP, 0.75
    ms. ``mlstm_chunk_bwd.launches`` counts the calls that launched."""
    W = _check(q, k, v, li, lf, chunk)
    for name, t in (("h", h), ("dh", dh)):
        if tuple(t.shape) != tuple(v.shape) or t.device != q.device:
            raise ValueError(f"{name} must be {tuple(v.shape)} on "
                             f"{q.device}, got {tuple(t.shape)} on {t.device}")
    if q.device.type == "cpu":
        return mlstm_chunk_bwd_plain(q, k, v, li, lf, h, dh, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunk_bwd runs on cpu or cuda, not "
                         f"{q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one type, float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have stride 1 along its last "
                             f"dimension, got strides {t.stride()}")
    out = _bwd_kernels(q, k, v, li, lf, h, dh, W)
    mlstm_chunk_bwd.launches += 1
    return out


mlstm_chunk_bwd.launches = 0


def _bwd_kernels(q: Tensor, k: Tensor, v: Tensor, li: Tensor, lf: Tensor,
                 h: Tensor, dh: Tensor, W: int):
    """The launch behind ``mlstm_chunk_bwd``, on checked inputs: the path
    is ``uses_tensor_cores``'s."""
    li, lf, h, dh = (t.float().contiguous() for t in (li, lf, h, dh))
    B, H, S, Dk = q.shape
    Dv = v.shape[-1]
    tc = uses_tensor_cores(q, k, v, W)
    lib = _build.load("mlstm_chunk_bwd", _bind_bwd)
    n_ws = lib.mlstm_chunk_bwd_workspace(B, H, S, Dk, Dv, W, int(tc))
    if n_ws < 0:
        raise ValueError(f"the mlstm_chunk_bwd kernels refuse B {B}, H {H}, "
                         f"S {S}, Dk {Dk}, Dv {Dv}, W {W}")
    # scratch (the recomputed states, S and dP, the sweep's dC and dn a
    # chunk, the rows' partial sums), then the outputs
    ws = torch.empty((n_ws,), dtype=torch.float32, device=q.device)
    dq, dk = torch.empty((2, B, H, S, Dk), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, H, S, Dv), dtype=q.dtype, device=q.device)
    dli, dlf = torch.empty((2, B, H, S), dtype=torch.float32,
                           device=q.device)
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = lib.mlstm_chunk_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(),
            lf.data_ptr(), h.data_ptr(), dh.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dli.data_ptr(), dlf.data_ptr(),
            ws.data_ptr(), int(q.dtype == torch.bfloat16), int(tc), B, H, S,
            Dk, Dv, W, (ctypes.c_longlong * 9)(*strides), Dk ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(
            f"mlstm_chunk_bwd kernel launch failed: "
            f"{lib.mlstm_chunk_bwd_error_string(err).decode()} ({err})")
    return dq, dk, dv, dli, dlf


class _MLSTMChunk(torch.autograd.Function):
    """Saves q, k, v, li, lf and h; its backward is ``mlstm_chunk_bwd``.
    C, n and m are outputs without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, li, lf, chunk):
        h, (C, n, m) = mlstm_chunk(q, k, v, li, lf, chunk=chunk)
        ctx.mark_non_differentiable(C, n, m)
        ctx.save_for_backward(q, k, v, li, lf, h)
        ctx.chunk = chunk
        return h, C, n, m

    @staticmethod
    def backward(ctx, dh, dC, dn, dm):
        q, k, v, li, lf, h = ctx.saved_tensors
        return (*mlstm_chunk_bwd(q, k, v, li, lf, h, dh, chunk=ctx.chunk),
                None)


def mlstm_chunk_train(q: Tensor, k: Tensor, v: Tensor, li: Tensor,
                      lf: Tensor, *, chunk: int = 256):
    """``mlstm_chunk`` with h differentiable in q, k, v, li and lf: the
    forward kernels (or the plain version on the CPU), and on the
    backward ``mlstm_chunk_bwd``. Returns (h, (C, n, m))."""
    h, C, n, m = _MLSTMChunk.apply(q, k, v, li, lf, chunk)
    return h, (C, n, m)
