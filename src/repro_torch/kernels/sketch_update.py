"""Fused EMA sketch-triple update: the CUDA kernels' wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/sketch_update.py::
sketch_update``. The kernels are in ``csrc/sketch_update.cu`` (CUDA C++
for ``sm_90a``, with ``csrc/ema_update.cuh`` and ``csrc/hopper.cuh``),
built at first use by ``kernels._build`` and called through ``ctypes``.

Bound on an H100 SXM: a call moves T*d*|A| + 3*T*k*4 + 6*d*k*4 bytes
and does 6*T*d*k flops. At the serving prefill shape (T=1024, d=2048,
k=9, bf16 A) that is 4.75 MB, 1.42 us at 3.35 TB/s; the 113 MFLOP
take 0.23 us on the bf16 tensor cores (989 TFLOP/s) even with the f32
projections split into bf16 high and low parts, which the tolerance
needs, so the bound is set by bytes. At k=33 it is 6.22 MB, 1.86 us;
at decode (T=8) 0.48 MB, 0.14 us, far under the launch latency.

Which kernel serves a call goes by A's dtype and shape alone:

- bf16 A with d % 8 == 0 and T > 64 (every full-width config's prefill
  and train step): the tensor-core kernel. Each f32 projection is split
  into hi = bf16(P) and lo = bf16(P - hi), and A^T hi + A^T lo runs on
  wgmma in f32; A streams in by TMA, once for all three products and
  every column of k. The data of A and of the projections must be
  16-byte aligned (they are read in 16-byte chunks), else the call
  raises.
- f32 A (the MLP trainer, the f32 serving paths), bf16 A with d % 8 !=
  0, or T <= 64 (decode, refill): the FMA kernel, exact f32 products, A
  read once for every k.

Both split T across blocks by ``launch_plan`` (cached per shape); the
splits write partial sums that a second kernel adds in a fixed order, so
two calls on the same inputs give the same bits.

A stacked call updates E triples in one launch: A (E, T, d), sketches
(E, d, k) and psi (E, k) against projections (T, k) that all E share,
as the TPU kernel runs under the reference's vmap over an (E, d, k)
node stack (the per-expert "expert_in" nodes). A grid axis runs over E;
each block offsets its pointers by its expert. The plan splits T only
where the E d-tiles leave SMs idle.

``sketch_update`` takes the plain version for CPU tensors and only for
them; for CUDA tensors it launches a kernel or raises.
``sketch_update.launches`` counts the calls that launched on the card;
``sketch_update.kernel_launches`` counts the kernels those calls
enqueued: two for a call whose T is split (a second pass sums the
splits), one otherwise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

MAX_K = 64
TC_TILE_D = 128    # d columns a tensor-core block owns (csrc/ema_update.cuh)
TC_ROWS = 64       # rows a tensor-core stage holds
FMA_TILE_D = 32    # d columns an FMA block owns
FMA_ROWS = 32      # rows an FMA stage holds
FMA_MAX_T = 64     # bf16 calls up to this T take the FMA kernel


def sketch_update_ref(a, x_s, y_s, z_s, ups, omg, phi, psi, beta):
    """The plain version (``repro.kernels.ref.sketch_update_ref``):
    a (T, d); x/y/z (d, k); ups/omg/phi (T, k); psi (k,). Stacked: a
    (E, T, d), x/y/z (E, d, k), psi (E, k), the projections shared."""
    at = a.float().transpose(-1, -2)
    x_new = beta * x_s + (1 - beta) * (at @ ups.float())
    y_new = beta * y_s + (1 - beta) * (at @ omg.float())
    z_new = beta * z_s + (1 - beta) * ((at @ phi.float())
                                       * psi.float()[..., None, :])
    return x_new, y_new, z_new


def uses_tensor_cores(T: int, d: int, a_dtype: torch.dtype) -> bool:
    """Whether a call with A (T, d) of type a_dtype takes the tensor-core
    kernel: bf16 rows of whole 16-byte chunks, and more than FMA_MAX_T of
    them (below that a call is launch-bound, and the FMA kernel measured
    faster on the card at T 8 to 64)."""
    return a_dtype == torch.bfloat16 and d % 8 == 0 and T > FMA_MAX_T


@functools.lru_cache(maxsize=1024)
def launch_plan(rows: int, d: int, num_sms: int, tensor_cores: bool,
                experts: int = 1) -> tuple[int, int]:
    """(splits, rows_per_split): how many blocks share the reduction
    over ``rows`` (T activation rows, or psparse's 3m support slots) of
    one d-tile of one expert, each a whole number of the kernel's stages
    and none empty. The tensor-core kernel aims at one wave of one block
    an SM, the FMA kernel's smaller blocks at two an SM (the aims that
    measured fastest on an H100, PERF.md)."""
    tile, step = ((TC_TILE_D, TC_ROWS) if tensor_cores
                  else (FMA_TILE_D, FMA_ROWS))
    tiles = -(-d // tile) * experts
    aim = num_sms // tiles if tensor_cores else -(-2 * num_sms // tiles)
    splits = max(1, min(-(-rows // step), aim))
    per = -(-(-(-rows // splits)) // step) * step
    return -(-rows // per), per


MAX_EXPERTS = 65535   # the grid's z extent


def check_stack(a, x_s) -> tuple[tuple[int, ...], int, int, int]:
    """(lead, rows, d, k) of A (rows, d) against sketches (d, k), or of a
    stacked A (E, rows, d) against (E, d, k): lead is () or (E,)."""
    if a.ndim not in (2, 3):
        raise ValueError(f"a must be (T, d) or (E, T, d), got shape "
                         f"{tuple(a.shape)}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"a must be float32 or bfloat16, got {a.dtype}")
    lead, (rows, d) = tuple(a.shape[:-2]), a.shape[-2:]
    if lead and not 1 <= lead[0] <= MAX_EXPERTS:
        raise ValueError(f"{lead[0]} experts outside 1..{MAX_EXPERTS}")
    if x_s.ndim != a.ndim or tuple(x_s.shape[:-2]) != lead \
            or x_s.shape[-2] != d:
        raise ValueError(f"sketches must be {lead + (d,)} + (k,), got "
                         f"{tuple(x_s.shape)}")
    k = x_s.shape[-1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside the kernel's range 1..{MAX_K}")
    if rows < 1 or d < 1 or max(rows, d) >= 2**31:
        raise ValueError(f"unsupported activation shape {(rows, d)}")
    return lead, rows, d, k


def _check(a, x_s, y_s, z_s, ups, omg, phi, psi):
    lead, T, d, k = check_stack(a, x_s)
    got = (x_s, y_s, z_s, ups, omg, phi, psi)
    dk = lead + (d, k)
    want = (dk, dk, dk, (T, k), (T, k), (T, k), lead + (k,))
    dev = a.device
    # one pass over the common case; the loops below name what is wrong
    if (tuple(t.shape for t in got) == want
            and all(t.dtype == torch.float32 and t.device == dev
                    and t.is_contiguous() for t in got)
            and a.is_contiguous()):
        return lead, T, d, k
    names = ("x_s", "y_s", "z_s", "ups", "omg", "phi", "psi")
    for name, t, w in zip(names, got, want):
        if tuple(t.shape) != w:
            raise ValueError(f"{name} must have shape {w}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in zip(("a",) + names, (a,) + got):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, a on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return lead, T, d, k


def check_index_range(d: int, k: int, splits: int) -> None:
    """The kernels index the sketches and the splits' partials in 32
    bits."""
    if 3 * d * k * splits >= 2**31:
        raise ValueError(f"d={d}, k={k} with {splits} splits is past the "
                         f"kernels' 32-bit sketch indices")


def check_aligned(**tensors: Tensor) -> None:
    """The tensor-core kernels read A's rows, and sketch_update's the
    projections' rows, in 16-byte chunks (TMA, cp.async): their data must
    start on a 16-byte boundary."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}'s data must be 16-byte aligned for the "
                             f"tensor-core kernel (bf16, d % 8 == 0, T > "
                             f"{FMA_MAX_T})")


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sketch_update_launch.argtypes = (
        [p, i] + [p] * 9 + [i] * 7 + [ctypes.c_float, p])
    lib.sketch_update_launch.restype = i
    lib.sketch_update_error_string.argtypes = [i]
    lib.sketch_update_error_string.restype = ctypes.c_char_p


def sketch_update(a, x_s, y_s, z_s, ups, omg, phi, psi, *, beta: float):
    """Fused EMA update; returns new f32 (x, y, z), each (d, k), views of
    one (3, d, k) buffer; stacked, each (E, d, k), views of one (E, 3,
    d, k) buffer, in one launch.

    a (T, d) f32 or bf16; x/y/z (d, k), ups/omg/phi (T, k) and psi (k,)
    f32; or a (E, T, d), x/y/z (E, d, k) and psi (E, k) against the same
    projections; all contiguous, on one device; k <= 64. CPU tensors
    take ``sketch_update_ref``; CUDA tensors launch the tensor-core
    kernel when ``uses_tensor_cores(T, d, a.dtype)``, else the FMA
    kernel.
    """
    lead, T, d, k = _check(a, x_s, y_s, z_s, ups, omg, phi, psi)
    if a.device.type == "cpu":
        return sketch_update_ref(a, x_s, y_s, z_s, ups, omg, phi, psi, beta)
    if a.device.type != "cuda":
        raise ValueError(f"sketch_update runs on cpu or cuda, not {a.device}")
    E = lead[0] if lead else 1
    tc = uses_tensor_cores(T, d, a.dtype)
    if tc:
        check_aligned(a=a, ups=ups, omg=omg, phi=phi)
    splits, rows = launch_plan(T, d, _build.num_sms(a.device), tc, E)
    check_index_range(d, k, splits)
    lib = _build.load("sketch_update", _bind)
    out = torch.empty(lead + (3, d, k), dtype=torch.float32,
                      device=a.device)
    ws = (torch.empty(lead + (splits, 3, d, k), dtype=torch.float32,
                      device=a.device) if splits > 1 else None)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sketch_update_launch(
            a.data_ptr(), int(a.dtype == torch.bfloat16), ups.data_ptr(),
            omg.data_ptr(), phi.data_ptr(), psi.data_ptr(), x_s.data_ptr(),
            y_s.data_ptr(), z_s.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            T, d, k, E, int(tc), splits, rows, float(beta), stream)
    if err:
        raise RuntimeError(
            f"sketch_update kernel launch failed: "
            f"{lib.sketch_update_error_string(err).decode()} ({err})")
    sketch_update.launches += 1
    sketch_update.kernel_launches += 1 if splits == 1 else 2
    return out.unbind(len(lead))


sketch_update.launches = 0
sketch_update.kernel_launches = 0
