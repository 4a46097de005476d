"""The mlstm_chunk kernels on a CUDA device against their plain version:
chunks shorter than, equal to and a quarter of the sequence, odd widths,
several column blocks, f32 and bf16 inputs, and v read as a strided view
of a (B, S, H, Dv) tensor, as the model passes it. The bf16 cases at Dk
512 with Dv and W multiples of 64 take the tensor-core kernels
(``uses_tensor_cores``, whose rule is tested without a card),
xlstm-1.3b's refill among them; the rest the FMA kernels.

Needs a CUDA device and nvcc: each test skips without one. This file
imports neither JAX nor the JAX package, so it runs where only the port
is installed:

    PYTHONPATH=src python -m pytest -q --noconftest \
        tests/test_torch_mlstm_chunk_cuda.py

Tolerance: h, C and n within rtol 1e-4, atol 1e-4 * max|plain|, m within
1e-4, the reference's own for its Pallas kernel
(``test_kernels.py::test_mlstm_chunk_sweep``): both sides compute in f32,
bf16 inputs widened exactly, and sum in other orders.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import mlstm_chunk as MC

CASES = [  # (B, H, S, Dk, Dv, chunk, dtype)
    (2, 2, 40, 8, 16, 256, torch.float32),        # S < chunk
    (1, 3, 64, 16, 32, 64, torch.float32),        # S = chunk
    (2, 2, 128, 32, 32, 32, torch.float32),       # S = 4 chunks
    (1, 2, 96, 24, 70, 32, torch.float32),        # odd widths, 3 col blocks
    (2, 2, 128, 32, 32, 32, torch.bfloat16),
    (1, 4, 512, 512, 1024, 256, torch.float32),   # the refill on FMAs
    # the tensor cores: W 64 over four chunks, W 128 over three chunks
    # and three column blocks, a chunk equal to S, xlstm-1.3b's refill
    (1, 2, 256, 512, 128, 64, torch.bfloat16),
    (2, 3, 384, 512, 192, 128, torch.bfloat16),
    (2, 1, 256, 512, 64, 256, torch.bfloat16),
    (1, 4, 512, 512, 1024, 256, torch.bfloat16),
]


def _inputs(seed, B, H, S, Dk, Dv, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(seed)

    def dev(a):
        return torch.from_numpy(a.astype(np.float32)).to("cuda")

    q, k = (dev(rng.standard_normal((B, H, S, Dk))).to(dtype)
            for _ in range(2))
    # v as the model lays it out: a (B, H, S, Dv) view of (B, S, H, Dv)
    v = dev(rng.standard_normal((B, S, H, Dv))).to(dtype).transpose(1, 2)
    li = dev(rng.standard_normal((B, H, S)) * 0.5)
    lf = torch.nn.functional.logsigmoid(dev(rng.standard_normal((B, H, S)))
                                        + 2.0)
    return q, k, v, li, lf


def _close(got, want, tol=1e-4):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,S,Dk,Dv,chunk,dtype", CASES)
def test_cuda_kernel_matches_plain_version(B, H, S, Dk, Dv, chunk, dtype):
    args = _inputs(S + Dv, B, H, S, Dk, Dv, dtype)
    assert MC.uses_tensor_cores(*args[:3], chunk) == (
        dtype == torch.bfloat16 and Dk == 512)
    before = MC.mlstm_chunk.launches
    h, (C, n, m) = MC.mlstm_chunk(*args, chunk=chunk)
    wh, (wC, wn, wm) = MC.mlstm_chunk_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert MC.mlstm_chunk.launches == before + 1
    assert h.dtype == C.dtype == torch.float32
    for got, want in ((h, wh), (C, wC), (n, wn)):
        _close(got, want)
    torch.testing.assert_close(m, wm, rtol=1e-4, atol=1e-4)


@pytest.mark.requires_cuda
def test_cuda_wrapper_refuses_what_the_kernels_do_not_take():
    q, k, v, li, lf = _inputs(0, 1, 2, 512, 8, 16, torch.float32)
    with pytest.raises(ValueError, match="at most"):
        MC.mlstm_chunk(q, k, v, li, lf, chunk=512)
    with pytest.raises(TypeError, match="one type"):
        MC.mlstm_chunk(q, k.bfloat16(), v, li, lf)
    q_cols = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="stride 1"):
        MC.mlstm_chunk(q_cols, k, v, li, lf)


def test_tensor_core_rule():
    """bf16 at Dk 512, Dv and W multiples of 64, 16-byte aligned rows;
    everything else the FMA kernels (CPU tensors: the rule reads only
    types, shapes, strides and addresses)."""
    def qkv(Dk=512, Dv=1024, S=512, dtype=torch.bfloat16, H=4):
        q = torch.zeros((1, H, S, Dk), dtype=dtype)
        v = torch.zeros((1, S, H, Dv), dtype=dtype).transpose(1, 2)
        return q, q, v

    assert MC.uses_tensor_cores(*qkv(), 256)          # the model's v view
    assert MC.uses_tensor_cores(*qkv(Dv=64, S=128), 64)
    assert not MC.uses_tensor_cores(*qkv(dtype=torch.float32), 256)
    assert not MC.uses_tensor_cores(*qkv(Dk=256), 256)
    assert not MC.uses_tensor_cores(*qkv(Dv=96), 256)
    assert not MC.uses_tensor_cores(*qkv(S=96), 256)      # W 96
    assert not MC.uses_tensor_cores(*qkv(), 32)           # W 32
    q, k, v = qkv(H=1)
    wide = torch.zeros((1, 1, 512, 516), dtype=torch.bfloat16)
    assert not MC.uses_tensor_cores(wide[..., 4:], k, v, 256)  # 8-byte rows
    wide = torch.zeros((1, 1, 512, 1028), dtype=torch.bfloat16)
    assert not MC.uses_tensor_cores(q, k, wide[..., :1024], 256)
