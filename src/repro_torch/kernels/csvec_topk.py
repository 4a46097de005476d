"""Count-sketch heavy-hitter search: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/csvec_topk.py::csvec_topk``.
The kernel is ``csrc/csvec_topk.cu`` (CUDA C++ for ``sm_90a``), built at
first use by ``kernels._build`` and called through ``ctypes``. It
returns the k coordinates of the sketched vector first by (|median-of-r
estimate| descending, index ascending), with their signed estimates,
never forming the (dim,) estimate vector.

Bound on an H100 SXM: the table is read once, 4 r c bytes: at the LM
train step's geometry (r = 5, c = 2^23) 168 MB, 0.050 ms at 3.35 TB/s;
the estimates' f32 work (sign products, the median network, the absolute
value: 26 operations a coordinate at r = 5) takes 0.43 ms at 67 TFLOP/s
and sets the bound. The data needs more: r * dim = 5.5e9 gathers at
random buckets of a table three times the L2, up to 176 GB of 32-byte
sectors, 52.5 ms. Blocks sweep ranges of coordinates and keep
block-local top-k lists in shared memory, folded by bitonic sorts; one
block merges the lists (the source file has the details).

Given the same table, the kernel's indices and values equal the plain
version's exactly, ties included. ``csvec_topk`` takes the plain version
for CPU tensors and only for them; for CUDA tensors it launches the
kernels or raises. ``csvec_topk.launches`` counts the calls that
launched on the card; each enqueues two kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.countsketch.csvec import (
    PLAIN_CHUNK, CSVec, _shift_for, topk_streaming,
)
from repro_torch.kernels import _build
from repro_torch.kernels.csvec_insert import (
    check_params, check_table, coeff_array,
)

Tensor = torch.Tensor

MAX_K = 1024               # largest k the shared-memory buffers take
THREADS = 256              # threads a block (csrc THREADS)
BLOCKS_PER_SM = 4          # pass-1 blocks
MIN_PER_BLOCK = 64 * THREADS


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def csvec_topk_ref(table: Tensor, params, dim: int, k: int,
                   chunk: int = PLAIN_CHUNK) -> tuple[Tensor, Tensor]:
    """The plain version: ``countsketch.csvec.topk_streaming``, (vals
    (k,) f32, idx (k,) int64) for k = min(k, dim)."""
    return topk_streaming(CSVec(table=table, params=params, dim=dim), k,
                          chunk)


def launch_plan(dim: int, k: int, sms: int) -> tuple[int, int, int, int]:
    """(kp, nb, blocks, per_block): the best-list length (k rounded up to
    a power of two), the shared buffer's entries, the pass-1 blocks and
    the coordinates each sweeps."""
    kp = _pow2(k)
    nb = _pow2(kp + 2 * THREADS)
    blocks = max(1, min(BLOCKS_PER_SM * sms, -(-dim // MIN_PER_BLOCK)))
    per_block = -(-dim // blocks)
    return kp, nb, blocks, per_block


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.csvec_topk_launch.argtypes = [p, i, i, i, p, ll, i, i, i, i, ll,
                                      p, p, p, p, p, p]
    lib.csvec_topk_launch.restype = i
    lib.csvec_topk_error_string.argtypes = [i]
    lib.csvec_topk_error_string.restype = ctypes.c_char_p


def csvec_topk(table: Tensor, params, dim: int,
               k: int) -> tuple[Tensor, Tensor]:
    """(vals (k,) f32, idx (k,) int64) of the top k = min(k, dim)
    coordinates of the vector sketched in ``table`` (r, c) f32 with
    ``params`` (4 rows of r uint32 host integers). CPU tensors take
    ``csvec_topk_ref``; CUDA tensors launch the kernels."""
    r, c = check_table(table)
    check_params(params, r)
    if not 1 <= dim < 2**31:
        raise ValueError(f"dim={dim} outside 1..2**31-1")
    k = min(int(k), dim)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside the kernel's range 1..{MAX_K}")
    if table.device.type == "cpu":
        return csvec_topk_ref(table, params, dim, k)
    if table.device.type != "cuda":
        raise ValueError(f"csvec_topk runs on cpu or cuda, not "
                         f"{table.device}")
    lib = _build.load("csvec_topk", _bind)
    dev = table.device
    kp, nb, blocks, per_block = launch_plan(dim, k, _build.num_sms(dev))
    s_mag = torch.empty((blocks, kp), dtype=torch.float32, device=dev)
    s_val = torch.empty((blocks, kp), dtype=torch.float32, device=dev)
    s_idx = torch.empty((blocks, kp), dtype=torch.int32, device=dev)
    vals = torch.empty((k,), dtype=torch.float32, device=dev)
    idx = torch.empty((k,), dtype=torch.int64, device=dev)
    coeffs = coeff_array(params)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.csvec_topk_launch(
            table.data_ptr(), r, c, _shift_for(c), coeffs, dim, k, kp, nb,
            blocks, per_block, s_mag.data_ptr(), s_val.data_ptr(),
            s_idx.data_ptr(), vals.data_ptr(), idx.data_ptr(), stream)
    if err:
        raise RuntimeError(
            f"csvec_topk kernel launch failed: "
            f"{lib.csvec_topk_error_string(err).decode()} ({err})")
    csvec_topk.launches += 1
    return vals, idx


csvec_topk.launches = 0
