"""Symmetric per-row int8 quantisation of a count-sketch table: the CUDA
kernel's wrapper and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/csvec_quant.py::
csvec_quant``. The kernel is ``csrc/csvec_quant.cu`` (CUDA C++ for
``sm_90a``), built at first use by ``kernels._build`` and called through
``ctypes``. It returns the int8 codes q, the row scales amax/127, the
dequantised table dhat = q * scale and the residual table - dhat; with
``dhat_only`` only scale and dhat, which is all the trainer keeps.

Bound on an H100 SXM (3.35 TB/s): the table is read once and q, dhat and
resid written once, 13 r c bytes: at the LM train step's geometry (r = 5,
c = 2^23) 545.3 MB, 162.8 us; scale and dhat alone 8 r c, 335.5 MB,
100.2 us. The TPU kernel holds the table in VMEM with one grid step. The
card's kernel takes the table row by row over a grid that co-resides
(``launch_plan``), holds each block's part of the row in registers and
shared memory while the row's amax is folded across the blocks, and
quantises from there, so the table is read from device memory once; the
source file has the details.

q, scale and dhat equal the plain version's bit for bit (IEEE division,
round half to even, no FMA contraction), NaN and inf included: a NaN in
a row makes its scale and dhat NaN, a NaN code is 0; resid to one
rounding of the row's amax. ``csvec_quant`` takes the plain version for
CPU tensors and only for them; for CUDA tensors it launches the kernel
or raises. ``csvec_quant.launches`` counts the calls that launched on
the card; each enqueues one kernel (the first call on a stream also
zeroes the stream's row words, which the kernel leaves at zero).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.countsketch.csvec import (
    dequantize_table, quantize_residual, quantize_table,
)
from repro_torch.kernels import _build
from repro_torch.kernels.csvec_insert import MAX_ROWS

Tensor = torch.Tensor

THREADS = 1024             # threads a block (csrc THREADS)
UNROLL = 4                 # loads in flight a thread (csrc UNROLL)
SMEM_ELEMS = 56 * 1024     # elements of a block's part in shared memory
_WORDS: dict[tuple[int, int], Tensor] = {}
_PER_SM: dict[tuple[int, int, bool], int] = {}


def csvec_quant_ref(table: Tensor):
    """The plain version (``repro.kernels.csvec_quant.csvec_quant_ref``):
    (q (r, c) int8, scale (r,) f32, dhat (r, c) f32, resid (r, c) f32)."""
    q, scale = quantize_table(table)
    dhat = dequantize_table(q, scale)
    return q, scale, dhat, quantize_residual(table, q, scale)


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    """The kernel's grid: ``vec`` elements a load, ``conc`` rows at a
    time, ``bpr`` blocks a row, each taking ``part`` elements of it, the
    first ``tile`` in registers and the next ``smem`` in shared memory
    (the rest, if any, twice through L2)."""

    vec: int
    conc: int
    bpr: int
    part: int
    smem: int

    @property
    def grid(self) -> int:
        return self.conc * self.bpr

    @property
    def tile(self) -> int:
        return THREADS * UNROLL * self.vec


def launch_plan(r: int, c: int, vec: int, blocks: int) -> QuantPlan:
    """The grid for an (r, c) table where ``blocks`` blocks co-reside on
    the card. A row needs ceil(c / (tile + SMEM_ELEMS)) blocks to stay on
    the chip. Rows that need the whole card run one at a time over all
    of it; shorter ones run ``conc`` at a time, each over the blocks the
    card has for it, but a block takes at least a tile (a row of a
    tile or less is one block's, with no handoff)."""
    tile = THREADS * UNROLL * vec
    need = -(-c // (tile + SMEM_ELEMS))
    if need >= blocks:
        conc, bpr = 1, blocks
    else:
        conc = min(r, blocks // need)
        bpr = max(need, min(blocks // conc, -(-c // tile)))
    part = -(-c // bpr)
    part = -(-part // vec) * vec
    bpr = -(-c // part)              # every block has elements
    return QuantPlan(vec=vec, conc=conc, bpr=bpr, part=part,
                     smem=min(SMEM_ELEMS, max(0, part - tile)))


def _check(table: Tensor) -> tuple[int, int]:
    if table.ndim != 2 or table.dtype != torch.float32:
        raise ValueError(f"table must be (r, c) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    r, c = table.shape
    if not 1 <= r <= MAX_ROWS:
        raise ValueError(f"r={r} outside the kernel's range 1..{MAX_ROWS}")
    if not 1 <= r * c < 2**31:
        raise ValueError(f"table of {r} x {c} counters outside the kernel's "
                         f"range")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    return r, c


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.csvec_quant_launch.argtypes = [p] * 6 + [i] * 7 + [p]
    lib.csvec_quant_launch.restype = i
    lib.csvec_quant_blocks_per_sm.argtypes = [i, i]
    lib.csvec_quant_blocks_per_sm.restype = i
    lib.csvec_quant_error_string.argtypes = [i]
    lib.csvec_quant_error_string.restype = ctypes.c_char_p


def _blocks(lib, dev, vec: int, full: bool) -> int:
    """Blocks of the kernel that co-reside on the card."""
    key = (dev.index, vec, full)
    if key not in _PER_SM:
        n = lib.csvec_quant_blocks_per_sm(vec, int(full))
        if n < 1:
            raise RuntimeError(
                f"csvec_quant occupancy query failed: "
                f"{lib.csvec_quant_error_string(-n).decode() if n else n}")
        _PER_SM[key] = n
    return _PER_SM[key] * _build.num_sms(dev)


def _words(dev, stream: int) -> Tensor:
    """The stream's row words (amax bits, arrivals, departures), zero
    between calls: each call's last block out of a row resets them."""
    key = (dev.index, stream)
    if key not in _WORDS:
        _WORDS[key] = torch.zeros((3 * MAX_ROWS,), dtype=torch.int32,
                                  device=dev)
    return _WORDS[key]


def csvec_quant(table: Tensor, *, dhat_only: bool = False):
    """(q, scale, dhat, resid) of ``table`` (r, c) f32, as
    ``csvec_quant_ref`` returns them, or ``(None, scale, dhat, None)``
    with ``dhat_only``. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    r, c = _check(table)
    if table.device.type == "cpu":
        if dhat_only:
            q, scale = quantize_table(table)
            return None, scale, dequantize_table(q, scale), None
        return csvec_quant_ref(table)
    if table.device.type != "cuda":
        raise ValueError(f"csvec_quant runs on cpu or cuda, not "
                         f"{table.device}")
    lib = _build.load("csvec_quant", _bind)
    dev = table.device
    vec = 4 if c % 4 == 0 and table.data_ptr() % 16 == 0 else 1
    plan = launch_plan(r, c, vec, _blocks(lib, dev, vec, not dhat_only))
    scale = torch.empty((r,), dtype=torch.float32, device=dev)
    dhat = torch.empty((r, c), dtype=torch.float32, device=dev)
    q = resid = None
    if not dhat_only:
        q = torch.empty((r, c), dtype=torch.int8, device=dev)
        resid = torch.empty((r, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.csvec_quant_launch(
            table.data_ptr(), _words(dev, stream).data_ptr(),
            None if q is None else q.data_ptr(), scale.data_ptr(),
            dhat.data_ptr(), None if resid is None else resid.data_ptr(), r,
            c, plan.vec, plan.conc, plan.bpr, plan.part, plan.smem, stream)
    if err:
        raise RuntimeError(
            f"csvec_quant kernel launch failed: "
            f"{lib.csvec_quant_error_string(err).decode()} ({err})")
    csvec_quant.launches += 1
    return q, scale, dhat, resid


csvec_quant.launches = 0
