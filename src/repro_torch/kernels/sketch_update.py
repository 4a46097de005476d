"""Fused EMA sketch-triple update: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/sketch_update.py::
sketch_update``. The kernel is ``csrc/sketch_update.cu`` (CUDA C++ for
``sm_90a``), built at first use by ``kernels._build`` and called
through ``ctypes``.

Bound on an H100 SXM: a call moves T*d*|A| + 3*T*k*4 + 6*d*k*4 bytes
and does 6*T*d*k flops. At the serving prefill shape (T=1024, d=2048,
k=9, bf16 A) that is 4.75 MB, 1.42 us at 3.35 TB/s; the 113 MFLOP
take 0.23 us on the bf16 tensor cores (989 TFLOP/s) even with the f32
projections split into bf16 high and low parts, which the tolerance
needs, so the bound is set by bytes. At k=33 it is 6.22 MB, 1.86 us;
at decode (T=8) 0.48 MB, 0.14 us, far under the launch latency. The
kernel reads A once for all three products, masks the ragged T/d/k
edges itself instead of padding in device memory, and splits T across
blocks so the 64 d-tiles of d=2048 still fill the card (the source file
has the details).

``sketch_update`` takes the plain version for CPU tensors and only for
them; for CUDA tensors it launches the kernel or raises.
``sketch_update.launches`` counts the calls that launched on the card;
``sketch_update.kernel_launches`` counts the kernels those calls
enqueued: two for a call whose T is split (a second pass sums the
splits), one otherwise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

MAX_K = 64
TILE_D = 32        # d columns per block (csrc TILE_D)
KC = 16            # projection columns per block (csrc KC)
MIN_ROWS = 64      # fewest rows a T-split gets

def sketch_update_ref(a, x_s, y_s, z_s, ups, omg, phi, psi, beta):
    """The plain version (``repro.kernels.ref.sketch_update_ref``):
    a (T, d); x/y/z (d, k); ups/omg/phi (T, k); psi (k,)."""
    at = a.float().T
    x_new = beta * x_s + (1 - beta) * (at @ ups.float())
    y_new = beta * y_s + (1 - beta) * (at @ omg.float())
    z_new = beta * z_s + (1 - beta) * ((at @ phi.float()) * psi.float()[None, :])
    return x_new, y_new, z_new


def launch_plan(T: int, d: int, k: int, num_sms: int) -> tuple[int, int]:
    """(splits, rows_per_split): how many blocks share the T reduction
    of one (d-tile, k-chunk). Aims at two blocks per SM, with at least
    MIN_ROWS rows per split and no empty split."""
    tiles = -(-d // TILE_D) * -(-k // KC)
    splits = max(1, min(-(-T // MIN_ROWS), -(-2 * num_sms // tiles)))
    rows = -(-T // splits)
    return -(-T // rows), rows


def _check(a, x_s, y_s, z_s, ups, omg, phi, psi) -> tuple[int, int, int]:
    if a.ndim != 2:
        raise ValueError(f"a must be (T, d), got shape {tuple(a.shape)}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"a must be float32 or bfloat16, got {a.dtype}")
    T, d = a.shape
    if x_s.ndim != 2 or x_s.shape[0] != d:
        raise ValueError(f"sketches must be (d={d}, k), got {tuple(x_s.shape)}")
    k = x_s.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside the kernel's range 1..{MAX_K}")
    if T < 1 or d < 1 or max(T, d) >= 2**31:
        raise ValueError(f"unsupported activation shape {(T, d)}")
    want = {"x_s": (d, k), "y_s": (d, k), "z_s": (d, k), "ups": (T, k),
            "omg": (T, k), "phi": (T, k), "psi": (k,)}
    got = {"x_s": x_s, "y_s": y_s, "z_s": z_s, "ups": ups, "omg": omg,
           "phi": phi, "psi": psi}
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must have shape {want[name]}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in {"a": a, **got}.items():
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return T, d, k


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sketch_update_launch.argtypes = (
        [p, i] + [p] * 11 + [i] * 5 + [ctypes.c_float, p])
    lib.sketch_update_launch.restype = i
    lib.sketch_update_error_string.argtypes = [i]
    lib.sketch_update_error_string.restype = ctypes.c_char_p


def sketch_update(a, x_s, y_s, z_s, ups, omg, phi, psi, *, beta: float):
    """Fused EMA update; returns new f32 (x, y, z), each (d, k).

    a (T, d) f32 or bf16; x/y/z (d, k), ups/omg/phi (T, k) and psi (k,)
    f32; all contiguous, on one device; k <= 64. CPU tensors take
    ``sketch_update_ref``; CUDA tensors launch the kernel.
    """
    T, d, k = _check(a, x_s, y_s, z_s, ups, omg, phi, psi)
    if a.device.type == "cpu":
        return sketch_update_ref(a, x_s, y_s, z_s, ups, omg, phi, psi, beta)
    if a.device.type != "cuda":
        raise ValueError(f"sketch_update runs on cpu or cuda, not {a.device}")
    lib = _build.load("sketch_update", _bind)
    splits, rows = launch_plan(T, d, k, _build.num_sms(a.device))
    outs = [torch.empty((d, k), dtype=torch.float32, device=a.device)
            for _ in range(3)]
    ws = (torch.empty((splits, 3, d, k), dtype=torch.float32,
                      device=a.device) if splits > 1 else None)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sketch_update_launch(
            a.data_ptr(), int(a.dtype == torch.bfloat16), ups.data_ptr(),
            omg.data_ptr(), phi.data_ptr(), psi.data_ptr(), x_s.data_ptr(),
            y_s.data_ptr(), z_s.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr(), outs[2].data_ptr(),
            ws.data_ptr() if ws is not None else None,
            T, d, k, splits, rows, float(beta), stream)
    if err:
        raise RuntimeError(
            f"sketch_update kernel launch failed: "
            f"{lib.sketch_update_error_string(err).decode()} ({err})")
    sketch_update.launches += 1
    sketch_update.kernel_launches += 1 if splits == 1 else 2
    return tuple(outs)


sketch_update.launches = 0
sketch_update.kernel_launches = 0
