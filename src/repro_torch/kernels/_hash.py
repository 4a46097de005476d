"""uint32 multiply-shift arithmetic in int64 tensors, shared by the
hashed projections (``kernels.psparse_update``) and the count-sketch
(``countsketch.csvec``).

PyTorch covers few uint32 operations, so a uint32 value is held in an
int64 tensor in [0, 2**32) and every result is masked with ``MASK32``:
the same bits as the wrapping uint32 arithmetic of the reference and of
the CUDA kernels.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

MASK32 = 0xFFFFFFFF


def mul32(a, u: Tensor) -> Tensor:
    """(a * u) mod 2**32 for uint32 ``a`` (a host int, or an int64
    tensor broadcasting against ``u``) and int64 ``u`` in [0, 2**32):
    ``a`` split into 16-bit halves keeps every product under 2**48,
    inside int64."""
    hi, lo = a >> 16, a & 0xFFFF
    return (((hi * u) & 0xFFFF) << 16) + lo * u & MASK32
