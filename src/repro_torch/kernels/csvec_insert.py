"""Count-sketch insert: the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces the TPU kernel ``src/repro/kernels/csvec_insert.py::
csvec_insert``. The kernel is ``csrc/csvec_insert.cu`` (CUDA C++ for
``sm_90a``), built at first use by ``kernels._build`` and called through
``ctypes``. It adds s_j(i) * vec[i] into bucket h_j(i) of every hash row
j, the multiply-shift hashes computed in registers from the index.

Bound on an H100 SXM (3.35 TB/s): a call reads the vector (4 n bytes)
and reads and writes the table (8 r c bytes). At the LM train step's
geometry (n = 1,100,048,384, r = 5, c = 2^23) that is 4.74 GB, 1.41 ms;
the 5.5e9 adds take 0.08 ms at the f32 rate. The adds land in random
buckets of a 168 MB table, three times the L2, and one atomic add in
device memory for each is bounded by the L2's atomic rate (the first
port: 173 ms). So the kernel partitions instead: each row's counters
are cut into bins that fit one block's shared memory (``insert_plan``).
For each chunk of v, a first kernel writes every tile's (bucket, signed
value) records sorted by bin, with a table of each bin's run in each
tile, and a second adds each bin's runs in shared memory and then onto
the table. The records live in scratch of at most ``SCRATCH_CAP`` bytes
(2 GiB), which sets the chunk; the source file has the details.

The sums come out in atomic order, so the kernel agrees with the plain
version to rounding, not bit for bit; the buckets and signs are exact.
The reference forms indices in int32, so n must be below 2**31.

``csvec_insert`` takes the plain version for CPU tensors and only for
them; for CUDA tensors it launches the kernel or raises.
``csvec_insert.launches`` counts the calls that launched on the card
(two kernels a chunk each).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.countsketch.csvec import (
    PLAIN_CHUNK, CSVec, _shift_for, insert,
)
from repro_torch.kernels import _build

Tensor = torch.Tensor

MAX_ROWS = 8               # hash rows the kernel takes (csrc MAX_ROWS)
TILE = 8192                # elements a records block (csrc TILE)
BIN_BITS = 15              # counters a bin: 2^15 f32, 128 KB of shared memory
MAX_BINS = 4096            # bins a row at most; wider bins sum in slices
RECORD_BYTES = 8           # a record: the bucket and the value's bits
SCRATCH_CAP = 2**31        # bytes of records and runs a call may hold

def csvec_insert_ref(table: Tensor, params, vec: Tensor,
                     chunk: int = PLAIN_CHUNK) -> Tensor:
    """The plain version (``repro.kernels.ref.csvec_insert_ref``):
    ``countsketch.csvec.insert`` of ``vec`` into ``table``."""
    return insert(CSVec(table=table, params=params, dim=vec.shape[0]), vec,
                  chunk).table


def check_params(params, rows: int) -> None:
    if len(params) != 4 or any(len(p) != rows for p in params) or any(
            not 0 <= int(c) < 2**32 for p in params for c in p):
        raise ValueError(f"params must be 4 rows of {rows} uint32 "
                         f"coefficients")


def check_table(table: Tensor) -> tuple[int, int]:
    if table.ndim != 2 or table.dtype != torch.float32:
        raise ValueError(f"table must be (r, c) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    r, c = table.shape
    _shift_for(c)
    if not 1 <= r <= MAX_ROWS:
        raise ValueError(f"r={r} outside the kernels' range 1..{MAX_ROWS}")
    if r * c >= 2**31:
        raise ValueError(f"table of {r} x {c} counters is too large")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    return r, c


def _check(table, params, vec) -> tuple[int, int, int]:
    r, c = check_table(table)
    check_params(params, r)
    if vec.ndim != 1 or vec.dtype != torch.float32:
        raise ValueError(f"vec must be (n,) float32, got {tuple(vec.shape)} "
                         f"{vec.dtype}")
    n = vec.shape[0]
    if n >= 2**31:
        raise ValueError(f"n={n} >= 2**31: the reference indexes in int32")
    if vec.device != table.device:
        raise ValueError(f"vec is on {vec.device}, table on {table.device}")
    if not vec.is_contiguous():
        raise ValueError("vec must be contiguous")
    return r, c, n


@dataclasses.dataclass(frozen=True)
class InsertPlan:
    """How the kernels cut an insert: bins of 2**bin_bits counters
    (``nbins`` a row), v in ``chunks`` chunks of ``chunk`` elements (a
    multiple of TILE)."""
    rows: int
    bin_bits: int
    nbins: int
    chunk: int
    chunks: int

    @property
    def kernels(self) -> int:
        """Kernels a call launches on the card: two a chunk."""
        return 2 * self.chunks

    @property
    def scratch_bytes(self) -> int:
        """A chunk's records and the table of their runs."""
        return _scratch(self.rows, self.nbins, self.chunk)


def _scratch(rows: int, nbins: int, chunk: int) -> int:
    return rows * chunk * RECORD_BYTES + rows * nbins * (chunk // TILE) * 4


def insert_plan(n: int, rows: int, cols: int) -> InsertPlan:
    """The bins and the chunks of an insert of n elements into a (rows,
    cols) table: bins of 2**15 counters (the whole row below that, wider
    bins where 2**15 would make more than MAX_BINS), and the fewest
    chunks whose scratch fits ``SCRATCH_CAP`` bytes, of near-equal
    length."""
    log2c = cols.bit_length() - 1
    bin_bits = max(min(log2c, BIN_BITS), log2c - MAX_BINS.bit_length() + 1)
    nbins = cols >> bin_bits
    longest = SCRATCH_CAP // _scratch(rows, nbins, TILE) * TILE
    chunks = max(1, -(-n // longest))
    per = -(-n // chunks)
    chunk = max(TILE, -(-per // TILE) * TILE)
    return InsertPlan(rows=rows, bin_bits=bin_bits, nbins=nbins, chunk=chunk,
                      chunks=-(-n // chunk))


def coeff_array(params):
    """The 4 * r coefficients as a C uint32 array, row after row."""
    flat = [int(c) for row in params for c in row]
    return (ctypes.c_uint32 * len(flat))(*flat)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.csvec_insert_launch.argtypes = [p, p, ll, i, i, i, p, p, p, i, ll, p]
    lib.csvec_insert_launch.restype = i
    lib.csvec_insert_error_string.argtypes = [i]
    lib.csvec_insert_error_string.restype = ctypes.c_char_p


def launch(out: Tensor, params, vec: Tensor, plan: InsertPlan) -> None:
    """Add the count-sketch of ``vec`` into ``out`` (CUDA, checked by the
    caller) in place, cut as ``plan`` says; the scratch is allocated here
    and freed to PyTorch's cache on return."""
    r, c = out.shape
    lib = _build.load("csvec_insert", _bind)
    rec = torch.empty((r * plan.chunk * RECORD_BYTES,), dtype=torch.uint8,
                      device=out.device)
    runs = torch.empty((r * plan.nbins * (plan.chunk // TILE),),
                       dtype=torch.int32, device=out.device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.csvec_insert_launch(
            out.data_ptr(), vec.data_ptr(), vec.shape[0], r, c, _shift_for(c),
            coeff_array(params), rec.data_ptr(), runs.data_ptr(),
            plan.bin_bits, plan.chunk, stream)
    if err:
        raise RuntimeError(
            f"csvec_insert kernel launch failed: "
            f"{lib.csvec_insert_error_string(err).decode()} ({err})")


def csvec_insert(table: Tensor, params, vec: Tensor) -> Tensor:
    """``table`` (r, c) f32 plus the count-sketch of ``vec`` (n,) f32,
    as a new tensor; ``params`` 4 rows of r uint32 host integers. CPU
    tensors take ``csvec_insert_ref``; CUDA tensors launch the kernels."""
    r, c, n = _check(table, params, vec)
    if table.device.type == "cpu":
        return csvec_insert_ref(table, params, vec)
    if table.device.type != "cuda":
        raise ValueError(f"csvec_insert runs on cpu or cuda, not "
                         f"{table.device}")
    out = table.clone()
    launch(out, params, vec, insert_plan(n, r, c))
    csvec_insert.launches += 1
    return out


csvec_insert.launches = 0
