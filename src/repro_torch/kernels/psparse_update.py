"""p-sparsified EMA sketch-triple update: the hash family, the CUDA
kernel's wrapper and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/psparse_update.py::
psparse_update``. The kernels are in ``csrc/psparse_update.cu`` (CUDA C++
for ``sm_90a``, with ``csrc/ema_update.cuh`` and ``csrc/hopper.cuh``),
built at first use by ``kernels._build`` and called through ``ctypes``.

Each implicit projection matrix (T, k) has m support rows. Support slot u
of matrix ``mat`` sits at row ``row_mat(u)`` and holds
``alpha * sgn_mat(u, j)`` in column j, with alpha = sqrt(T/m):

    row(u)    = (((a1*u + b1) >> 16) * T) >> 16           in [0, T)
    sgn(u, j) = 1 - 2 * ((a2*(u << 16 | j) + b2) >> 31)   in {-1, +1}

all in uint32 arithmetic that wraps. Duplicate support rows add, as in a
CountSketch. The update is

    X' = beta X + (1-beta) A^T Upsilon,  Y' likewise with Omega,
    Z' = beta Z + (1-beta) (A^T Phi) * psi,

and A^T Omega = A[rows]^T (alpha * sgn): only m rows of A take part.

Bound on an H100 SXM (3.35 TB/s): a call must read the distinct support
rows (at most 3*m*d*|A| bytes) and read and write the sketches
(6*d*k*4 bytes); its 6*m*d*k flops are negligible. At the LM's FFN
shapes (T=1024, m=102, k=17, bf16 A) that is 0.58 and 1.58 us at d 2048
and 5632; at the trainer's shapes (T=128, f32 A) 0.17 us. The Pallas
kernel builds one-hot (t_blk, m) tiles and reads all of A; these
regenerate the rows and signs from the 12 coefficients, which the
wrapper passes as kernel arguments (host integers: no device read and
no stream sync per call), and read only the support rows.

Which kernel serves a call goes by A's dtype and shape alone, as in
``sketch_update`` (``uses_tensor_cores``): bf16 A with d % 8 == 0 and
T > 64 takes the tensor-core kernel, which gathers the support rows with
cp.async and sums sgn^T A[rows] on wgmma (+-1 is exact in bf16; alpha is
applied in the epilogue); the rest the FMA kernel. Both split the 3m
support slots across blocks by ``sketch_update.launch_plan`` and sum the
splits in a fixed order in a second kernel. An A with fewer rows than
the binding (a carry's B rows against the tree's token rows) takes the
FMA kernel over only the few slots whose row it holds (``live_slots``).

A stacked call updates E triples in one launch, as ``sketch_update``'s
does: A (E, rows, d), sketches (E, d, k) and psi (E, k) against hashes
all E share (the per-expert "expert_in" nodes), a grid axis over E.

``psparse_update`` takes the plain version for CPU tensors and only for
them; for CUDA tensors it launches a kernel or raises.
``psparse_update.launches`` counts the calls that launched on the card,
``psparse_update.kernel_launches`` the kernels they enqueued (two where
the slots are split).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._hash import MASK32 as _MASK32
from repro_torch.kernels._hash import mul32 as _mul32
from repro_torch.kernels.sketch_update import (
    check_aligned, check_index_range, check_stack, launch_plan,
    uses_tensor_cores,
)

Tensor = torch.Tensor

MAX_K = 64
NAMES = ("upsilon", "omega", "phi")


# -- hash family -------------------------------------------------------------


def psparse_dim(num_tokens: int, k_max: int, density: float) -> int:
    """Support size m = clamp(round(p * T), k_max, T)."""
    return int(min(num_tokens, max(k_max, round(density * num_tokens))))


def psparse_scale(num_tokens: int, m: int) -> float:
    """alpha = sqrt(T/m): every implicit entry has unit variance."""
    return math.sqrt(num_tokens / m)


def psparse_hash_params(gen: torch.Generator,
                        rows: int = 3) -> tuple[tuple[int, ...], ...]:
    """``rows`` tuples [a_row, b_row, a_sign, b_sign] of uint32 values
    drawn from ``gen``, the multipliers forced odd (2-universal hashes).
    Host integers, so a launch never reads them back from the device."""
    bits = torch.randint(0, 2**32, (rows, 4), generator=gen,
                         dtype=torch.int64, device=gen.device).tolist()
    return tuple((r[0] | 1, r[1], r[2] | 1, r[3]) for r in bits)


def psparse_rows(params_m, m: int, num_tokens: int,
                 device="cpu") -> Tensor:
    """(m,) int64 support rows in [0, num_tokens) of one matrix."""
    u = torch.arange(m, dtype=torch.int64, device=device)
    h = (_mul32(params_m[0], u) + params_m[1]) & _MASK32
    return ((h >> 16) * num_tokens & _MASK32) >> 16


def psparse_signs(params_m, m: int, k: int, device="cpu") -> Tensor:
    """(m, k) f32 in {-1, +1}: the top bit of the sign hash of the
    packed index (u << 16 | j)."""
    uu = (torch.arange(m, dtype=torch.int64, device=device)[:, None]
          << 16) & _MASK32
    jj = torch.arange(k, dtype=torch.int64, device=device)[None, :]
    h = (_mul32(params_m[2], uu | jj) + params_m[3]) & _MASK32
    return 1.0 - 2.0 * (h >> 31).to(torch.float32)


def psparse_dense_one(params_m, num_tokens: int, k: int, m: int,
                      device="cpu") -> Tensor:
    """One implicit (T, k) matrix, materialised as the reference does:
    one-hot(row(u) == t) @ (alpha * sgn), so duplicate rows add."""
    rows = psparse_rows(params_m, m, num_tokens, device)
    sgn = psparse_signs(params_m, m, k, device) * psparse_scale(num_tokens, m)
    onehot = (rows[None, :] == torch.arange(num_tokens, device=device)[:, None])
    return onehot.to(torch.float32) @ sgn


def psparse_dense(params, num_tokens: int, k: int, m: int,
                  device="cpu") -> dict:
    """{"upsilon","omega","phi"}: the three implicit (T, k) matrices."""
    return {name: psparse_dense_one(params[i], num_tokens, k, m, device)
            for i, name in enumerate(NAMES)}


def psparse_triple_increment(a: Tensor, params, psi: Tensor, beta: float,
                             m: int, num_tokens: int | None = None
                             ) -> tuple[Tensor, Tensor, Tensor]:
    """The (1-beta)-scaled f32 increments against the implicit
    projections: A[rows]^T (alpha * sgn) for each matrix, the Z one
    times psi (pre-masked, (k,)). Gathers the m support rows of A and
    never materialises a projection. The rows hash into [0, num_tokens)
    (default: A's rows); an A with fewer rows (a carry's B) is the
    binding's first rows, the rest zero, so its support rows past A's
    are skipped. A stacked a (E, rows, d) with psi (E, k) gives (E, d,
    k) increments."""
    rows_a = a.shape[-2]
    T, k = num_tokens or rows_a, psi.shape[-1]
    a = a.detach().float()
    scale = (1.0 - beta) * psparse_scale(T, m)
    outs = []
    for p in params:
        rows = psparse_rows(p, m, T, a.device)
        sgn = psparse_signs(p, m, k, a.device)
        if T > rows_a:
            live = rows < rows_a
            rows, sgn = rows[live], sgn[live]
        outs.append(scale * (a.index_select(-2, rows).transpose(-1, -2)
                             @ sgn))
    return outs[0], outs[1], outs[2] * psi.float()[..., None, :]


# -- the update: plain version and kernel wrapper -----------------------------


def psparse_update_ref(a, x_s, y_s, z_s, params, psi, *, beta: float,
                       m: int, num_tokens: int | None = None):
    """The plain version: ``beta * S + increment`` for each sketch."""
    inc = psparse_triple_increment(a, params, psi, beta, m, num_tokens)
    return tuple(beta * s + i for s, i in zip((x_s, y_s, z_s), inc))


def _check(a, x_s, y_s, z_s, params, psi, m, num_tokens):
    lead, rows, d, k = check_stack(a, x_s)
    T = num_tokens or rows
    if not 1 <= rows <= T:
        raise ValueError(f"a has {rows} rows, past the binding's "
                         f"num_tokens={T}")
    if T >= 2**31:
        raise ValueError(f"unsupported binding num_tokens={T}")
    if not 1 <= m <= T:
        raise ValueError(f"support size m={m} outside 1..T={T}")
    if len(params) != 3 or any(
            len(p) != 4 or any(not 0 <= int(c) < 2**32 for c in p)
            for p in params):
        raise ValueError("params must be 3 rows of 4 uint32 coefficients")
    dk = lead + (d, k)
    want = {"x_s": dk, "y_s": dk, "z_s": dk, "psi": lead + (k,)}
    got = {"x_s": x_s, "y_s": y_s, "z_s": z_s, "psi": psi}
    dev = a.device
    # one pass over the common case; the loops below name what is wrong
    if (tuple(t.shape for t in got.values()) == tuple(want.values())
            and all(t.dtype == torch.float32 and t.device == dev
                    and t.is_contiguous() for t in got.values())
            and a.is_contiguous()):
        return lead, T, d, k
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
    return lead, T, d, k


def _bind(lib: ctypes.CDLL) -> None:
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    lib.psparse_update_launch.argtypes = (
        [p, i] + [p] * 6 + [u] * 12 + [i] * 6 + [p] + [i] * 4 + [f, f, p])
    lib.psparse_update_launch.restype = i
    lib.psparse_update_error_string.argtypes = [i]
    lib.psparse_update_error_string.restype = ctypes.c_char_p


@functools.lru_cache(maxsize=64)
def live_slots(params: tuple, m: int, num_tokens: int, rows: int,
               device) -> Tensor:
    """(n,) int32 on ``device``: the slots s = mat m + u of the 3m whose
    support row falls below ``rows``, the only ones that add anything
    when A holds the binding's first ``rows`` rows (a carry's B). Made
    once for each binding, so a launch reads no device memory back."""
    slots = [mat * m + u for mat, p in enumerate(params)
             for u in (psparse_rows(p, m, num_tokens) < rows)
             .nonzero()[:, 0].tolist()]
    return torch.tensor(slots, dtype=torch.int32, device=device)


def psparse_update(a, x_s, y_s, z_s, params, psi, *, beta: float, m: int,
                   num_tokens: int | None = None):
    """Fused psparse EMA update; returns new f32 (x, y, z), each (d, k),
    views of one (3, d, k) buffer; stacked, each (E, d, k), views of one
    (E, 3, d, k) buffer, in one launch.

    a (rows, d) f32 or bf16; x/y/z (d, k) and psi (k,) f32, psi
    pre-masked; or a (E, rows, d), x/y/z (E, d, k) and psi (E, k);
    ``params`` 3 rows of 4 uint32 host integers; all tensors
    contiguous on one device; k <= 64. The support rows hash into [0,
    num_tokens) (default: a's rows); an ``a`` with fewer rows is the
    binding's first rows, and the support rows past them add nothing
    (a carry's B rows against the tree's B S). Column masking of the
    outputs is the caller's. CPU tensors take ``psparse_update_ref``;
    CUDA tensors launch the tensor-core kernel when
    ``uses_tensor_cores(T, d, a.dtype)`` and a holds every row, else the
    FMA kernel, which for fewer rows sums only the ``live_slots``.
    """
    lead, T, d, k = _check(a, x_s, y_s, z_s, params, psi, m, num_tokens)
    if a.device.type == "cpu":
        return psparse_update_ref(a, x_s, y_s, z_s, params, psi, beta=beta,
                                  m=m, num_tokens=T)
    if a.device.type != "cuda":
        raise ValueError(f"psparse_update runs on cpu or cuda, not {a.device}")
    E, rows_a = (lead[0] if lead else 1), a.shape[-2]
    slots = None
    if rows_a < T:
        slots = live_slots(tuple(tuple(int(c) for c in p) for p in params),
                           m, T, rows_a, a.device)
    tc = slots is None and uses_tensor_cores(T, d, a.dtype)
    if tc:
        check_aligned(a=a)
    n_slots = 3 * m if slots is None else slots.numel()
    splits, per = launch_plan(max(n_slots, 1), d, _build.num_sms(a.device),
                              tc, E)
    check_index_range(d, k, splits)
    lib = _build.load("psparse_update", _bind)
    out = torch.empty(lead + (3, d, k), dtype=torch.float32,
                      device=a.device)
    ws = (torch.empty(lead + (splits, 3, d, k), dtype=torch.float32,
                      device=a.device) if splits > 1 else None)
    coeffs = [int(c) for row in params for c in row]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.psparse_update_launch(
            a.data_ptr(), int(a.dtype == torch.bfloat16), psi.data_ptr(),
            x_s.data_ptr(), y_s.data_ptr(), z_s.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None, *coeffs, T, d, k, m,
            E, rows_a, slots.data_ptr() if slots is not None else None,
            -1 if slots is None else n_slots, int(tc), splits, per,
            psparse_scale(T, m), float(beta), stream)
    if err:
        raise RuntimeError(
            f"psparse_update kernel launch failed: "
            f"{lib.psparse_update_error_string(err).decode()} ({err})")
    psparse_update.launches += 1
    psparse_update.kernel_launches += 1 if splits == 1 else 2
    return out.unbind(len(lead))


psparse_update.launches = 0
psparse_update.kernel_launches = 0
