"""Causal GQA flash attention, optionally in a sliding window, forward and
backward: the CUDA kernels' wrappers, their plain PyTorch versions and
the autograd Function the model calls.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention`` (forward only). Its gradient, for which the JAX package
has no Pallas kernel (XLA differentiates the model's checkpointed scan),
is the gradient of ``src/repro/kernels/ref.py::flash_attention_ref``.
The kernels are ``csrc/flash_attention.cu`` (CUDA C++ for ``sm_90a``),
built at first use by ``kernels._build`` and called through ``ctypes``.

Layout as the TPU kernel's: q (B, Hq, S, D), k and v (B, Hkv, S, D);
query head h reads KV head h // (Hq // Hkv). Scores are f32, scaled by
D^-1/2, masked (q >= k, and q - k < window); o comes back in q's type,
with the row log-sum-exp lse = m + log(max(l, 1e-30)) in f32. Any
S >= 1. The plain versions compute the function in f32 throughout.

The kernels take two paths, by the input type alone:

- bf16 (head_dim 64, 128, 160, 256): the tensor cores. Every product is a
  ``wgmma`` with f32 accumulators on tiles that TMA brings into shared
  memory through 4-D tensor maps of the tensors' own strides (so the
  (b, h, s) strides and the base address must be multiples of 16 bytes);
  a producer warpgroup streams tiles through a two-stage mbarrier ring
  to two consumer warpgroups of 64 rows. P (forward and backward) and dS
  are rounded to bf16 before their products, as the JAX model's chunked
  scan rounds P, so the bf16 results differ from the f32 plain version
  by that rounding as well as by the final rounding to bf16
  (``BF16_TOL``, per row). At head_dim 256 (recurrentgemma-2b) the
  dk/dv pass gives each block 64 keys and its two consumer warpgroups
  one output each, dV and dK. bf16 at head_dim 16 is refused: only the
  reduced configs have it, and they run in f32.
- f32 (head_dim 16, 64, 128, 160): the f32 FMA kernels of the first
  version, exact to the plain version but for the order of the sums.
  f32 at head_dim 256 is refused: its dq pass's tiles would not fit
  shared memory, and no path runs it (the reduced configs are head_dim
  16).

Bound on an H100 SXM: forward 4 D operations a live (q, k) pair, backward
10 D (S (S + 1) / 2 live pairs a head, sum_i min(i + 1, w) with a
window w), against 989 TFLOP/s for bf16 on the tensor cores and
67 TFLOP/s for f32; q, k, v and o are read or written once. At
tinyllama-1.1b's context (B 4, S 2048, 32/4 heads, D 64) the forward's
68.7 GFLOP take 69.5 us on the tensor cores, far above its 9.5 us of
bytes, so operations bound it. The kernels skip whole tiles outside the
causal frontier and the window (the TPU kernel's block skip, as loop
bounds), keep the running max, sum and accumulator in registers, and
save only o and lse for the backward: nothing of size S x S reaches
device memory.

``flash_attention_fwd`` and ``flash_attention_bwd`` take the plain
versions for CPU tensors and only for them; for CUDA tensors they launch
the kernels or raise. ``flash_attention_fwd.launches`` counts forward
launches; ``flash_attention_bwd.launches`` counts backward calls, each
of which enqueues two to four kernels (delta = rowsum(do * o), written
by a pre-pass in bf16 and by the dq pass in f32; the dq pass; the dk/dv
pass; and where that pass splits the query heads of a group over
blocks, the ordered sum of its partials).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

NEG_INF = -1e30
HEAD_DIMS = (16, 64, 128, 160, 256)  # the ported configs' head_dim (csrc)
BF16_HEAD_DIMS = (64, 128, 160, 256)  # those of the tensor-core kernels
F32_HEAD_DIMS = (16, 64, 128, 160)    # those of the FMA kernels
PLAIN_CHUNK = 1024                 # keys a step of the plain versions
# bf16 o, dq, dk, dv of the kernels against the f32 plain versions. The
# tensor-core kernels round P and dS to bf16 before their products and
# the results to bf16. Each element may differ by BF16_TOL times (its
# |plain| + the largest |plain| of its row along D): rows are query rows
# for o and dq and keys for dk and dv, so that the late rows of a long
# sequence, whose values are a small share of the first rows' (|o| of
# row i falls as (i + 1)^-1/2), answer to their own scale. A row whose
# largest is under ROW_FLOOR of the tensor's (dq's first row: zero but
# for the rounding of dP - delta) answers to that floor instead. Over
# chip_smoke.py's bf16 FLASH_CASES (NVIDIA H100 80GB HBM3, 700 W) the
# largest row gap read 0.0078 (one bf16 ulp, 2^-7) and no element used
# more than 0.49 of its allowance (a margin of 2), while each mutant of
# tools/flash_mutants.py used 50 to 1,232 of it wherever it changes the
# result (PERF.md).
BF16_TOL = 1e-2
ROW_FLOOR = 1e-3


def bf16_gaps(got: Tensor, want: Tensor) -> tuple[float, float]:
    """(gap, used) of a bf16 result against its plain version: the
    largest |got - want| over its row's scale (as above), and the largest
    share of its allowance that an element uses. The check passes where
    used <= 1; a NaN or inf in ``got`` fails it."""
    w = want.float().abs()
    row = w.amax(dim=-1, keepdim=True).clamp_min(ROW_FLOOR * float(w.max()))
    diff = (got.float() - want.float()).abs()
    return (float((diff / row).max()),
            float((diff / (BF16_TOL * (row + w))).max()))


def _live(S: int, k0: int, k1: int, window: int | None, device) -> Tensor:
    """(S, k1 - k0) mask of the live (query, key) pairs."""
    rel = (torch.arange(S, device=device)[:, None]
           - torch.arange(k0, k1, device=device)[None, :])
    live = rel >= 0
    if window is not None:
        live &= rel < window
    return live


def _grouped(t: Tensor, hkv: int) -> Tensor:
    """(B, Hq, S, D) -> f32 (B, Hkv, G, S, D)."""
    B, Hq, S, D = t.shape
    return t.float().reshape(B, hkv, Hq // hkv, S, D)


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, *,
                          window: int | None = None) -> tuple[Tensor, Tensor]:
    """The function in plain PyTorch, an online softmax over
    ``PLAIN_CHUNK`` keys at a time: (o (B, Hq, S, D) in q's type, lse
    (B, Hq, S) f32)."""
    B, Hq, S, D = q.shape
    hkv = k.shape[1]
    qf = _grouped(q, hkv) * D ** -0.5
    m = torch.full(qf.shape[:-1], NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, S, PLAIN_CHUNK):
        k1 = min(S, k0 + PLAIN_CHUNK)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k[:, :, k0:k1].float())
        s = torch.where(_live(S, k0, k1, window, q.device), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p, v[:, :, k0:k1].float())
        m = m_new
    l = torch.clamp(l, min=1e-30)
    o = (acc / l[..., None]).reshape(B, Hq, S, D).to(q.dtype)
    return o, (m + torch.log(l)).reshape(B, Hq, S)


def flash_attention_bwd_plain(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                              lse: Tensor, do: Tensor, *,
                              window: int | None = None):
    """(dq, dk, dv) in their inputs' types from the forward's o and lse,
    P rebuilt as exp(s - lse) ``PLAIN_CHUNK`` keys at a time; dk and dv
    sum over the G query heads of each KV head."""
    B, Hq, S, D = q.shape
    hkv = k.shape[1]
    scale = D ** -0.5
    qf = _grouped(q, hkv) * scale
    dof = _grouped(do, hkv)
    delta = (dof * _grouped(o, hkv)).sum(dim=-1)
    lse5 = lse.reshape(delta.shape)
    dq = torch.zeros_like(qf)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty_like(dk)
    for k0 in range(0, S, PLAIN_CHUNK):
        k1 = min(S, k0 + PLAIN_CHUNK)
        kj, vj = k[:, :, k0:k1].float(), v[:, :, k0:k1].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kj)
        p = torch.where(_live(S, k0, k1, window, q.device),
                        torch.exp(s - lse5[..., None]), 0.0)
        dv[:, :, k0:k1] = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
        ds = p * (torch.einsum("bhgqd,bhkd->bhgqk", dof, vj)
                  - delta[..., None])
        dq += torch.einsum("bhgqk,bhkd->bhgqd", ds, kj)
        dk[:, :, k0:k1] = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf)
    return ((dq * scale).reshape(q.shape).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check(q: Tensor, k: Tensor, v: Tensor, window: int | None,
           **more: Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"q must be (B, Hq, S, D) and k, v (B, Hkv, S, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    B, Hq, S, D = q.shape
    hkv = k.shape[1]
    if S < 1 or hkv < 1 or Hq % hkv or tuple(k.shape) != (B, hkv, S, D):
        raise ValueError(f"k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    want = {"v": tuple(k.shape), "o": tuple(q.shape), "do": tuple(q.shape),
            "lse": (B, Hq, S)}
    for name, t in {"k": k, "v": v, **more}.items():
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must have shape {want[name]}, got "
                             f"{tuple(t.shape)}")
        dtype = torch.float32 if name == "lse" else q.dtype
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _check_cuda(D: int, **tensors: Tensor) -> None:
    """What the kernels take beyond ``_check``: a compiled head_dim
    (``BF16_HEAD_DIMS`` in bf16, ``F32_HEAD_DIMS`` in f32), unit stride
    along D, lse contiguous; in bf16 (the tensor maps of the tensor-core
    kernels) base addresses and (b, h, s) strides of whole 16-byte
    units."""
    bf16 = tensors["q"].dtype == torch.bfloat16
    dims = BF16_HEAD_DIMS if bf16 else F32_HEAD_DIMS
    if D not in dims:
        raise ValueError(f"head_dim {D} has no {tensors['q'].dtype} "
                         f"flash_attention kernel; the kernels take {dims}")
    for name, t in tensors.items():
        if name == "lse":
            if not t.is_contiguous():
                raise ValueError("lse must be contiguous")
            continue
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have stride 1 along D, got "
                             f"strides {t.stride()}")
        if bf16 and (t.data_ptr() % 16 or any(
                st % 8 for st, n in zip(t.stride()[:3], t.shape[:3])
                if n > 1)):
            raise ValueError(f"{name} must start and step (b, h, s) in "
                             f"16-byte units for the tensor maps, got "
                             f"strides {t.stride()}")


def _strides(*ts: Tensor):
    """The (b, h, s) element strides of each tensor, as a C array."""
    flat = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd_launch.argtypes = (
        [p] * 5 + [i] * 6 + [p, i, f, p])
    lib.flash_attention_fwd_launch.restype = i
    lib.flash_attention_bwd_launch.argtypes = (
        [p] * 10 + [i] * 6 + [p, i, f, i, p, p])
    lib.flash_attention_bwd_launch.restype = i
    lib.flash_attention_encode_us.argtypes = [p] + [i] * 4 + [p, i]
    lib.flash_attention_encode_us.restype = ctypes.c_double
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(
            f"flash_attention {what} kernel launch failed: "
            f"{lib.flash_attention_error_string(err).decode()} ({err})")


def flash_attention_fwd(q: Tensor, k: Tensor, v: Tensor, *,
                        window: int | None = None):
    """(o, lse) as ``flash_attention_plain`` returns them. CPU tensors
    take the plain version; CUDA tensors launch the forward kernel. o
    has q's memory layout (a transposed view in, a transposed view
    out)."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    B, Hq, S, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    _check_cuda(D, q=q, k=k, v=v, o=o)
    lib = _build.load("flash_attention", _bind)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), int(q.dtype == torch.bfloat16), B, Hq,
            k.shape[1], S, D, _strides(q, k, v, o), window or 0, D ** -0.5,
            stream)
    _raise_on(lib, err, "forward")
    flash_attention_fwd.launches += 1
    return o, lse


def dkdv_keys(D: int, dtype: torch.dtype) -> int:
    """Keys a block of the dk/dv pass owns: 64 in the f32 kernels, 128 in
    the bf16 ones, 64 in bf16 at head_dim 256 (the split kernel)."""
    return 128 if dtype == torch.bfloat16 and D != 256 else 64


def dkdv_splits(B: int, hkv: int, S: int, G: int, sms: int,
                keys: int = 64) -> int:
    """Slices of each KV head's G query heads that the dk/dv pass gives
    blocks of their own: enough for two blocks an SM (MQA's one KV head
    leaves most SMs idle otherwise), at most G. A block owns ``keys``
    keys (``dkdv_keys``)."""
    blocks = -(-S // keys) * hkv * B
    return max(1, min(G, -(-2 * sms // blocks)))


def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                        lse: Tensor, do: Tensor, *,
                        window: int | None = None):
    """(dq, dk, dv) as ``flash_attention_bwd_plain`` returns them, each
    in its input's memory layout. CPU tensors take the plain version;
    CUDA tensors launch the backward kernels."""
    _check(q, k, v, window, o=o, lse=lse, do=do)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    B, Hq, S, D = q.shape
    hkv = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    _check_cuda(D, q=q, k=k, v=v, o=o, do=do, lse=lse, dq=dq, dk=dk, dv=dv)
    sms = _build.num_sms(q.device)
    splits = dkdv_splits(B, hkv, S, Hq // hkv, sms, dkdv_keys(D, q.dtype))
    part = (torch.empty((2, splits, B, hkv, S, D), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    lib = _build.load("flash_attention", _bind)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), int(q.dtype == torch.bfloat16), B,
            Hq, hkv, S, D, _strides(q, k, v, o, do, dq, dk, dv),
            window or 0, D ** -0.5, splits,
            None if part is None else part.data_ptr(), stream)
    _raise_on(lib, err, "backward")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Saves q, k, v, o and lse; its backward is ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        o, lse = flash_attention_fwd(q, k, v, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window = window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         window=ctx.window)
        return dq, dk, dv, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *,
                    window: int | None = None) -> Tensor:
    """Attention output (B, Hq, S, D) in q's type, differentiable in q, k
    and v: the forward kernel (or plain version on the CPU), and on the
    backward the backward kernels."""
    return _FlashAttention.apply(q, k, v, window)
