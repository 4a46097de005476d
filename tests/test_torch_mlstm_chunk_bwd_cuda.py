"""The mlstm_chunk_bwd kernels on a CUDA device against their plain
version: a chunk longer than, equal to and a quarter of the sequence,
odd and ragged widths, several column blocks, rows where the
denominator's exp(-m) branch wins (li strongly negative), f32 and bf16
inputs, v read as a strided view of a (B, S, H, Dv) tensor as the model
passes it, and xlstm-1.3b's train shapes (B 4 x S 512, two chunks; B 1
x S 2048, eight) with the model's forget gates: lf = logsigmoid(b_h +
N(0, 1)), b_h = linspace(3, 6) over the heads as models/ssm.py sets the
forget biases, a decay of e^-0.6 to e^-12.5 over a 256-token chunk, so
the dC carried into an earlier chunk is large. The small cases draw
logsigmoid(N(0, 1) + 2), e^-33 over 256 tokens, which their short chunks
still carry across. bf16 inputs at Dk 512 with Dv and the chunk
multiples of 64 take the tensor-core kernels (``uses_tensor_cores``):
the full-width bf16 cases, a narrow one (Dv 128, four 64-token chunks)
with and without the exp(-m) branch, and three 128-token chunks at Dv
192; the rest take the FMA kernels.

Needs a CUDA device and nvcc: each test skips without one. This file
imports neither JAX nor the JAX package, so it runs where only the port
is installed:

    PYTHONPATH=src python -m pytest -q --noconftest \\
        tests/test_torch_mlstm_chunk_bwd_cuda.py

Tolerance (``mlstm_chunk.bwd_gap``): each gradient within rtol 1e-4,
atol 1e-4 * max|plain| of the plain version's f32 gradient of the same
inputs, both sides in f32 summing in other orders; bf16 outputs are that
f32 value rounded once, so they get the rounding's 2^-8 |plain| on top.
The kernels use no atomics: two calls give the same bits.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import mlstm_chunk as MC

CASES = [  # (B, H, S, Dk, Dv, chunk, dtype, li shift, forget gates)
    (2, 2, 40, 8, 16, 256, torch.float32, 0.0, "steep"),      # S < chunk
    (1, 3, 64, 16, 32, 64, torch.float32, 0.0, "steep"),      # S = chunk
    (2, 2, 128, 32, 32, 32, torch.float32, 0.0, "steep"),     # 4 chunks
    (1, 2, 96, 24, 70, 32, torch.float32, 0.0, "steep"),      # odd widths
    (2, 1, 48, 5, 7, 24, torch.float32, 0.0, "steep"),        # ragged
    (1, 2, 64, 8, 16, 16, torch.float32, -8.0, "steep"),      # exp(-m)
    (2, 2, 128, 32, 32, 32, torch.bfloat16, 0.0, "steep"),
    (4, 4, 512, 512, 1024, 256, torch.float32, 0.0, "model"),  # train
    (4, 4, 512, 512, 1024, 256, torch.bfloat16, 0.0, "model"),
    (1, 4, 2048, 512, 1024, 256, torch.bfloat16, 0.0, "model"),
    (1, 2, 256, 512, 128, 64, torch.bfloat16, 0.0, "steep"),   # narrow tc
    (1, 2, 256, 512, 128, 64, torch.bfloat16, -8.0, "steep"),  # its exp(-m)
    (2, 3, 384, 512, 192, 128, torch.bfloat16, 0.0, "model"),  # W 128
]


def _inputs(seed, B, H, S, Dk, Dv, dtype, shift, chunk=256, gates="steep"):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(seed)

    def dev(a):
        return torch.from_numpy(a.astype(np.float32)).to("cuda")

    q, k = (dev(rng.standard_normal((B, H, S, Dk))).to(dtype)
            for _ in range(2))
    v = dev(rng.standard_normal((B, S, H, Dv))).to(dtype).transpose(1, 2)
    li = dev(rng.standard_normal((B, H, S)) * 0.5 + shift)
    bias = (np.linspace(3.0, 6.0, H)[:, None] if gates == "model" else 2.0)
    lf = torch.nn.functional.logsigmoid(
        dev(rng.standard_normal((B, H, S)) + bias))
    h, _ = MC.mlstm_chunk(q, k, v, li, lf, chunk=chunk)
    dh = dev(rng.standard_normal((B, H, S, Dv)))
    return q, k, v, li, lf, h, dh


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,S,Dk,Dv,chunk,dtype,shift,gates", CASES)
def test_cuda_kernel_matches_plain_version(B, H, S, Dk, Dv, chunk, dtype,
                                           shift, gates):
    q, k, v, li, lf, h, dh = _inputs(S + Dv, B, H, S, Dk, Dv, dtype, shift,
                                     chunk, gates)
    before = MC.mlstm_chunk_bwd.launches
    got = MC.mlstm_chunk_bwd(q, k, v, li, lf, h, dh, chunk=chunk)
    want = MC.mlstm_chunk_bwd_plain(q.float(), k.float(), v.float(), li, lf,
                                    h, dh, chunk=chunk)
    torch.cuda.synchronize()
    assert MC.mlstm_chunk_bwd.launches == before + 1
    assert [g.dtype for g in got] == [dtype] * 3 + [torch.float32] * 2
    gaps = {name: MC.bwd_gap(g, w)
            for name, g, w in zip(("dq", "dk", "dv", "dli", "dlf"), got,
                                  want)}
    assert max(gaps.values()) <= 1, gaps


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,S,Dk,Dv,chunk,dtype,shift,gates", [
    c for c in CASES if c[3] == 512 and c[6] == torch.bfloat16])
def test_bf16_at_xlstm_widths_takes_the_tensor_cores(B, H, S, Dk, Dv, chunk,
                                                     dtype, shift, gates):
    q, k, v, *_ = _inputs(0, B, H, S, Dk, Dv, dtype, shift, chunk, gates)
    assert MC.uses_tensor_cores(q, k, v, chunk)
    assert not MC.uses_tensor_cores(q.float(), k.float(), v.float(), chunk)


@pytest.mark.requires_cuda
def test_two_calls_give_the_same_bits():
    args = _inputs(3, 4, 4, 512, 512, 1024, torch.bfloat16, 0.0,
                   gates="model")
    one = MC.mlstm_chunk_bwd(*args)
    two = MC.mlstm_chunk_bwd(*args)
    for a, b in zip(one, two):
        assert torch.equal(a, b)


@pytest.mark.requires_cuda
def test_autograd_reaches_the_kernel():
    """``mlstm_chunk_train``'s backward launches the kernels and gives
    the plain backward's gradients."""
    q, k, v, li, lf, _, dh = _inputs(4, 1, 2, 64, 16, 32, torch.float32, 0.0,
                                     32)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v, li, lf)]
    before = MC.mlstm_chunk_bwd.launches
    h, _ = MC.mlstm_chunk_train(*leaves, chunk=32)
    grads = torch.autograd.grad(h, leaves, dh)
    assert MC.mlstm_chunk_bwd.launches == before + 1
    want = MC.mlstm_chunk_bwd_plain(q, k, v, li, lf, h.detach(), dh, chunk=32)
    for g, w in zip(grads, want):
        assert MC.bwd_gap(g, w) <= 1


@pytest.mark.requires_cuda
def test_cuda_wrapper_refuses_what_the_kernels_do_not_take():
    q, k, v, li, lf, h, dh = _inputs(0, 1, 2, 64, 8, 16, torch.float32, 0.0)
    with pytest.raises(TypeError, match="one type"):
        MC.mlstm_chunk_bwd(q, k.bfloat16(), v, li, lf, h, dh)
    q_cols = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="stride 1"):
        MC.mlstm_chunk_bwd(q_cols, k, v, li, lf, h, dh)
    wide = torch.zeros((1, 2, 64, 520), device="cuda")
    with pytest.raises(ValueError, match="refuse"):
        MC.mlstm_chunk_bwd(wide, wide, v, li, lf, h, dh)
    with pytest.raises(ValueError, match="dh must be"):
        MC.mlstm_chunk_bwd(q, k, v, li, lf, h, dh[..., :8])
