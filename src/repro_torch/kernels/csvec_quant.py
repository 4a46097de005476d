"""Symmetric per-row int8 quantisation of a count-sketch table: the CUDA
kernel's wrapper and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/csvec_quant.py::
csvec_quant``. The kernel is ``csrc/csvec_quant.cu`` (CUDA C++ for
``sm_90a``), built at first use by ``kernels._build`` and called through
``ctypes``. It returns the int8 codes q, the row scales amax/127, the
dequantised table dhat = q * scale and the residual table - dhat.

Bound on an H100 SXM (3.35 TB/s): the table is read once and q, dhat and
resid written once, 13 r c bytes: at the LM train step's geometry (r = 5,
c = 2^23) 546 MB, 0.163 ms. The TPU kernel holds the table in VMEM with
one grid step; at 168 MB the card needs a reduction across blocks first,
so the kernel reads the table twice (a row-amax pass with atomicMax on
the bits of |t|, then the quantisation pass; the source file has the
details).

q, scale and dhat equal the plain version's bit for bit (IEEE division,
round half to even, no FMA contraction); resid to one rounding of the
row's amax. ``csvec_quant`` takes the plain version for CPU tensors and
only for them; for CUDA tensors it launches the kernels or raises.
``csvec_quant.launches`` counts the calls that launched on the card;
each enqueues a memset of its scratch and two kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.countsketch.csvec import (
    dequantize_table, quantize_residual, quantize_table,
)
from repro_torch.kernels import _build
from repro_torch.kernels.csvec_insert import check_table

Tensor = torch.Tensor

THREADS = 256              # threads a block (csrc THREADS)
BLOCKS_PER_SM = 4


def csvec_quant_ref(table: Tensor):
    """The plain version (``repro.kernels.csvec_quant.csvec_quant_ref``):
    (q (r, c) int8, scale (r,) f32, dhat (r, c) f32, resid (r, c) f32)."""
    q, scale = quantize_table(table)
    dhat = dequantize_table(q, scale)
    return q, scale, dhat, quantize_residual(table, q, scale)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.csvec_quant_launch.argtypes = [p] * 6 + [i, i, i, p]
    lib.csvec_quant_launch.restype = i
    lib.csvec_quant_error_string.argtypes = [i]
    lib.csvec_quant_error_string.restype = ctypes.c_char_p


def csvec_quant(table: Tensor):
    """(q, scale, dhat, resid) of ``table`` (r, c) f32, as
    ``csvec_quant_ref`` returns them. CPU tensors take the plain
    version; CUDA tensors launch the kernels."""
    r, c = check_table(table)
    if table.device.type == "cpu":
        return csvec_quant_ref(table)
    if table.device.type != "cuda":
        raise ValueError(f"csvec_quant runs on cpu or cuda, not "
                         f"{table.device}")
    lib = _build.load("csvec_quant", _bind)
    dev = table.device
    q = torch.empty((r, c), dtype=torch.int8, device=dev)
    scale = torch.empty((r,), dtype=torch.float32, device=dev)
    dhat = torch.empty((r, c), dtype=torch.float32, device=dev)
    resid = torch.empty((r, c), dtype=torch.float32, device=dev)
    amax = torch.empty((r,), dtype=torch.int32, device=dev)
    per_row = max(1, -(-BLOCKS_PER_SM * _build.num_sms(dev) // r))
    blocks = max(1, min(-(-c // THREADS), per_row))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.csvec_quant_launch(
            table.data_ptr(), amax.data_ptr(), q.data_ptr(), scale.data_ptr(),
            dhat.data_ptr(), resid.data_ptr(), r, c, blocks, stream)
    if err:
        raise RuntimeError(
            f"csvec_quant kernel launch failed: "
            f"{lib.csvec_quant_error_string(err).decode()} ({err})")
    csvec_quant.launches += 1
    return q, scale, dhat, resid


csvec_quant.launches = 0
