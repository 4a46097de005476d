"""CSVec — a count-sketch of a length-``dim`` vector (counterpart of
``repro.countsketch.csvec``).

The sketch is an (r hash rows x c buckets) table; element i of the
source vector lands in bucket h_j(i) of row j with sign s_j(i). Both
hashes are multiply-shift: with a_j odd,

    h_j(i) = (a_j * i + b_j)  >>  (32 - log2 c)      (c a power of two)
    s_j(i) = 1 - 2 * ((a'_j * i + b'_j) >> 31)

in uint32 arithmetic that wraps, computed here in int64 with
``kernels._hash.mul32`` and in the CUDA kernels natively; buckets and
signs agree bit for bit with the reference's.

The (4, r) coefficients [a_bucket; b_bucket; a_sign; b_sign] are host
integers (a tuple of four r-tuples), so a kernel launch takes them as
arguments and reads nothing back from the card. ``make_csvec`` draws
them from a ``torch.Generator``: the two packages draw different hash
families from the same ``cs_seed``, so the differential tests inject
the reference's coefficients.

The functions here are the plain versions. They sweep long vectors in
chunks, so they run at a billion coordinates on the card without an
(r, dim) intermediate; their results do not depend on the chunk. The
fused kernels are ``kernels.csvec_insert``, ``kernels.csvec_topk`` and
``kernels.csvec_quant``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels._hash import MASK32, mul32

Tensor = torch.Tensor

PLAIN_CHUNK = 1 << 22          # coordinates per chunk of the plain sweeps
QMAX = 127.0                   # symmetric int8 grid: {-127..127}


@dataclasses.dataclass
class CSVec:
    """Count-sketch state: the (r, c) f32 table and the hash
    coefficients ((a_b, ...), (b_b, ...), (a_s, ...), (b_s, ...))."""

    table: Tensor
    params: tuple[tuple[int, ...], ...]
    dim: int

    @property
    def rows(self) -> int:
        return self.table.shape[0]

    @property
    def cols(self) -> int:
        return self.table.shape[1]


def _shift_for(cols: int) -> int:
    log2c = cols.bit_length() - 1
    if cols != (1 << log2c):
        raise ValueError(f"cols must be a power of two, got {cols}")
    return 32 - log2c


def hash_params(gen: torch.Generator, rows: int) -> tuple[tuple[int, ...], ...]:
    """(4, r) uint32 coefficients from ``gen``, the multipliers (rows 0
    and 2) forced odd."""
    bits = torch.randint(0, 2**32, (4, rows), generator=gen,
                         dtype=torch.int64, device=gen.device).tolist()
    bits[0] = [a | 1 for a in bits[0]]
    bits[2] = [a | 1 for a in bits[2]]
    return tuple(tuple(row) for row in bits)


def make_csvec(gen: torch.Generator, dim: int, rows: int, cols: int,
               device=None) -> CSVec:
    """Zero table on ``device`` (the generator's by default) and hash
    coefficients from ``gen``. The reference's ``make_csvec`` draws its
    coefficients with ``jax.random.bits``: from the same ``cs_seed`` the
    two packages draw different hash families."""
    _shift_for(cols)
    return CSVec(table=torch.zeros((rows, cols), dtype=torch.float32,
                                   device=device or gen.device),
                 params=hash_params(gen, rows), dim=int(dim))


def zero_table(cs: CSVec) -> CSVec:
    return dataclasses.replace(cs, table=torch.zeros_like(cs.table))


def _coeff(params, row: int, device) -> Tensor:
    return torch.tensor(params[row], dtype=torch.int64, device=device)[:, None]


def _u32(idx: Tensor) -> Tensor:
    return idx.to(torch.int64)[None, :] & MASK32


def hash_buckets(params, cols: int, idx: Tensor) -> Tensor:
    """(r, n) int64 bucket of each index per hash row."""
    shift = _shift_for(cols)
    i = _u32(idx)
    h = (mul32(_coeff(params, 0, idx.device), i)
         + _coeff(params, 1, idx.device)) & MASK32
    return h >> shift


def hash_signs(params, idx: Tensor) -> Tensor:
    """(r, n) f32 in {-1, +1}: the top bit of the second hash."""
    i = _u32(idx)
    h = (mul32(_coeff(params, 2, idx.device), i)
         + _coeff(params, 3, idx.device)) & MASK32
    return 1.0 - 2.0 * (h >> 31).to(torch.float32)


def _chunks(n: int, chunk: int):
    for start in range(0, n, chunk):
        yield start, min(start + chunk, n)


def _segment_add(acc: Tensor, params, idx: Tensor, vals: Tensor) -> None:
    """acc[j, h_j(i)] += s_j(i) * vals[i] for every row j (in place)."""
    buckets = hash_buckets(params, acc.shape[1], idx)
    sv = hash_signs(params, idx) * vals.to(torch.float32)[None, :]
    for j in range(acc.shape[0]):
        acc[j].index_add_(0, buckets[j], sv[j])


def insert_at(cs: CSVec, idx: Tensor, vals: Tensor) -> CSVec:
    """Accumulate a sparse vector (``vals`` at coordinates ``idx``, zero
    elsewhere) into the sketch: ``table + segment sums``."""
    acc = torch.zeros_like(cs.table)
    _segment_add(acc, cs.params, idx, vals)
    return dataclasses.replace(cs, table=cs.table + acc)


def insert(cs: CSVec, vec: Tensor, chunk: int = PLAIN_CHUNK) -> CSVec:
    """Accumulate ``vec`` (dim,) into the sketch: ``insert_at`` over
    every coordinate, swept in chunks into one bucket-sum table that is
    added to the old table at the end, as the reference adds its
    segment sums."""
    acc = torch.zeros_like(cs.table)
    for a, b in _chunks(vec.shape[0], chunk):
        idx = torch.arange(a, b, dtype=torch.int64, device=vec.device)
        _segment_add(acc, cs.params, idx, vec[a:b])
    return dataclasses.replace(cs, table=cs.table + acc)


def merge(a: CSVec, b: CSVec) -> CSVec:
    """Exact linear merge; both sketches must share hash coefficients."""
    if a.dim != b.dim or a.table.shape != b.table.shape:
        raise ValueError("CSVec merge: mismatched sketch geometry")
    return dataclasses.replace(a, table=a.table + b.table)


def median_rows(est: Tensor) -> Tensor:
    """Median over axis 0 of (r, n) estimates: an odd-even transposition
    network (min/max only), then the middle, or for even r the midpoint
    (lo + hi) * 0.5 as ``jnp.median`` takes it (``torch.median`` would
    take the lower middle)."""
    rows = list(est)
    r = len(rows)
    for rnd in range(r):
        for j in range(rnd % 2, r - 1, 2):
            rows[j], rows[j + 1] = (torch.minimum(rows[j], rows[j + 1]),
                                    torch.maximum(rows[j], rows[j + 1]))
    if r % 2:
        return rows[r // 2]
    return (rows[r // 2 - 1] + rows[r // 2]) * 0.5


def query(cs: CSVec, idx: Tensor) -> Tensor:
    """Median-of-r estimate of vec[idx] (any shape of idx)."""
    flat = idx.reshape(-1)
    buckets = hash_buckets(cs.params, cs.cols, flat)
    est = hash_signs(cs.params, flat) * cs.table.gather(1, buckets)
    return median_rows(est).reshape(idx.shape)


def query_all(cs: CSVec) -> Tensor:
    """(dim,) estimate of every coordinate (the dense oracle)."""
    return query(cs, torch.arange(cs.dim, device=cs.table.device))


def select_topk(mag: Tensor, k: int) -> Tensor:
    """Positions of the k largest ``mag`` by (mag desc, position asc):
    a stable descending sort (``torch.topk`` leaves the order of ties
    undefined)."""
    return torch.sort(mag, descending=True, stable=True).indices[:k]


def topk_streaming(cs: CSVec, k: int,
                   chunk: int = PLAIN_CHUNK) -> tuple[Tensor, Tensor]:
    """Top-k coordinates by |median estimate| without the (dim,)
    estimate: chunk by chunk, the running best (k,) buffer and the
    chunk's estimates are sorted together and cut to k. The buffer
    precedes the chunk and holds only smaller indices, so the stable
    sort breaks ties toward the smaller index, as the reference's
    ``lax.top_k`` does. Returns (vals (k,) f32 signed estimates, idx
    (k,) int64), by descending |estimate|."""
    k = min(k, cs.dim)
    dev = cs.table.device
    bv = torch.zeros(0, dtype=torch.float32, device=dev)
    bi = torch.zeros(0, dtype=torch.int64, device=dev)
    for a, b in _chunks(cs.dim, chunk):
        idx = torch.arange(a, b, dtype=torch.int64, device=dev)
        allv = torch.cat([bv, query(cs, idx)])
        alli = torch.cat([bi, idx])
        pos = select_topk(allv.abs(), k)
        bv, bi = allv[pos], alli[pos]
    return bv, bi


def unsketch(cs: CSVec, k: int) -> Tensor:
    """Dense (dim,) vector holding the top-k heavy hitters at their
    estimates, zero elsewhere (the O(r * dim) oracle)."""
    est = query_all(cs)
    idx = select_topk(est.abs(), min(k, cs.dim))
    out = torch.zeros(cs.dim, dtype=torch.float32, device=est.device)
    out[idx] = est[idx]
    return out


def table_bytes(cs: CSVec) -> int:
    """Bytes a worker puts on the wire per merge (the table only)."""
    return cs.table.numel() * cs.table.element_size()


# -- int8 wire format --------------------------------------------------------


def quantize_rows(x: Tensor) -> tuple[Tensor, Tensor]:
    """Symmetric per-row (last-axis) int8 quantization: (q int8, scale
    (..., 1) f32) with dequant = q * scale. All-zero rows get scale 0;
    rounding is half to even (``torch.round``, like ``jnp.round``).
    The divisions are IEEE, as the reference's: on CUDA, PyTorch turns a
    division by a Python number into a product with its reciprocal, so
    QMAX is divided as a tensor."""
    t = x.to(torch.float32)
    amax = t.abs().amax(dim=-1, keepdim=True)
    scale = amax / torch.full_like(amax, QMAX)
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(t / safe), -QMAX, QMAX)
    return q.to(torch.int8), scale


def dequantize_rows(q: Tensor, scale: Tensor) -> Tensor:
    return q.to(torch.float32) * scale


def quantize_table(table: Tensor) -> tuple[Tensor, Tensor]:
    """(q (r, c) int8, scale (r,) f32) of an (r, c) sketch table."""
    q, scale = quantize_rows(table)
    return q, scale[:, 0]


def dequantize_table(q: Tensor, scale: Tensor) -> Tensor:
    return q.to(torch.float32) * scale[:, None]


def quantize_residual(table: Tensor, q: Tensor, scale: Tensor) -> Tensor:
    """``table - dequant(q, scale)``: the quantization error that stays
    in the worker's error feedback."""
    return table.to(torch.float32) - dequantize_table(q, scale)


def quantized_table_bytes(cs: CSVec) -> int:
    """int8 wire cost of one table merge: a byte per counter plus the r
    f32 row scales."""
    return cs.table.numel() + cs.rows * 4
