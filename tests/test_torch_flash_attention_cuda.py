"""The flash attention kernels on a CUDA device against their plain
versions, at every compiled head_dim: f32 (the FMA kernels, head_dim
16, 64, 128, 160) and bf16 (the tensor-core kernels, head_dim 64, 128,
160, 256), in the model's layout ((B, S, H, D) storage read as (B, H, S,
D)), at lengths that span several tiles, end ragged, or pass a window,
MQA (recurrentgemma's 10 query heads on one KV head at head_dim 256),
with the dk/dv pass split over query-head slices and not; two backward
calls bit for bit equal; f32 at head_dim 256 and bf16 at 16 refused.

Needs a CUDA device and nvcc: each test skips without one. This file
imports neither JAX nor the JAX package, so it runs where only the port
is installed:

    PYTHONPATH=src python -m pytest -q --noconftest \
        tests/test_torch_flash_attention_cuda.py

Tolerances: f32 rtol and atol 1e-4 of the largest plain value (the
sums run in another order), lse (f32 in both types) too; bf16 o, dq, dk
and dv ``flash_attention.BF16_TOL`` of each query row's or key's own
largest plain value (``flash_attention.bf16_gaps``: the tensor-core
kernels round P and dS to bf16 before their products; the plain versions
stay in f32).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA

CASES = [  # (B, Hq, Hkv, S, D, window, dtype)
    (2, 4, 2, 37, 16, None, torch.float32),
    (1, 4, 2, 80, 16, 32, torch.float32),
    (2, 4, 2, 37, 64, None, torch.bfloat16),
    (1, 4, 2, 80, 64, 32, torch.bfloat16),
    (2, 8, 2, 130, 64, None, torch.float32),
    (2, 8, 2, 130, 64, None, torch.bfloat16),
    (1, 4, 1, 200, 128, 64, torch.float32),
    (1, 4, 1, 200, 128, 64, torch.bfloat16),
    (1, 8, 2, 300, 128, 100, torch.bfloat16),
    (1, 4, 2, 96, 160, None, torch.float32),
    (1, 4, 2, 96, 160, None, torch.bfloat16),
    (1, 4, 2, 300, 160, 100, torch.bfloat16),
    # internvl2-76b's GQA 8:1 at head_dim 128
    (1, 16, 2, 300, 128, None, torch.bfloat16),
    # enough KV tiles and heads that the dk/dv pass takes one slice of
    # each group (the cases above split it and sum partials)
    (2, 4, 4, 2100, 16, 300, torch.float32),
    (4, 4, 4, 1100, 64, None, torch.bfloat16),
    # musicgen-large's MHA (one query head a KV head, so no split) at
    # head_dim 64, its last tile ragged
    (2, 8, 8, 1030, 64, None, torch.bfloat16),
    # head_dim 256: the dk/dv pass's split kernel (64 keys a block, a
    # dV and a dK warpgroup), split over query heads and not
    (2, 10, 1, 130, 256, None, torch.bfloat16),
    (1, 10, 1, 300, 256, 100, torch.bfloat16),
    (4, 4, 4, 1100, 256, None, torch.bfloat16),
]


def _cuda_inputs(seed, B, Hq, Hkv, S, D, dtype):
    """q, k, v, do from numpy, on the card in the model's layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, S, h, D)).astype(
        np.float32)).to("cuda", dtype).transpose(1, 2)
        for h in (Hq, Hkv, Hkv, Hq)]


def _close(got, want):
    """bf16 within BF16_TOL of each row's scale, f32 within 1e-4 of
    max|want|."""
    if got.dtype == torch.bfloat16:
        gap, used = FA.bf16_gaps(got, want)
        assert used <= 1, f"used {used} of the allowance, row gap {gap}"
        return
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-4,
                               atol=1e-4 * scale)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,D,window,dtype", CASES)
def test_cuda_kernels_match_plain_versions(B, Hq, Hkv, S, D, window, dtype):
    q, k, v, do = _cuda_inputs(S + D, B, Hq, Hkv, S, D, dtype)
    before = (FA.flash_attention_fwd.launches, FA.flash_attention_bwd.launches)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = FA.dkdv_splits(B, Hkv, S, Hq // Hkv, sms, FA.dkdv_keys(D, dtype))
    assert (splits == 1) == (S > 1000)
    o, lse = FA.flash_attention_fwd(q, k, v, window=window)
    want_o, want_lse = FA.flash_attention_plain(q, k, v, window=window)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, window=window)
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, window=window)
    torch.cuda.synchronize()
    assert (FA.flash_attention_fwd.launches,
            FA.flash_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    # o and the gradients come back in their inputs' layout
    assert o.stride() == q.stride() and got[1].stride() == k.stride()
    _close(o, want_o)
    _close(lse, want_lse)
    for g, w in zip(got, want):
        _close(g, w)
    # no atomics: the same inputs give the same bits
    again = FA.flash_attention_bwd(q, k, v, o, lse, do, window=window)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.requires_cuda
def test_cuda_bf16_refuses_what_the_tensor_maps_cannot_take():
    q, k, v, _ = _cuda_inputs(2, 1, 4, 2, 64, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 16 has no"):
        FA.flash_attention_fwd(q[..., :16], k[..., :16], v[..., :16])
    # rows 4 elements (8 bytes) apart
    odd = torch.zeros((1, 64, 4, 68), dtype=torch.bfloat16,
                      device="cuda")[..., :64].transpose(1, 2)
    with pytest.raises(ValueError, match="16-byte units"):
        FA.flash_attention_fwd(odd, k, v)


@pytest.mark.requires_cuda
def test_cuda_f32_refuses_head_dim_256():
    """No path runs f32 at head_dim 256 (the reduced configs are head_dim
    16), and its dq pass's tiles would not fit shared memory."""
    q, k, v, do = _cuda_inputs(3, 1, 4, 1, 64, 256, torch.float32)
    with pytest.raises(ValueError, match="head_dim 256 has no"):
        FA.flash_attention_fwd(q, k, v)
    lse = torch.zeros((1, 4, 64), device="cuda")
    with pytest.raises(ValueError, match="head_dim 256 has no"):
        FA.flash_attention_bwd(q, k, v, q, lse, do)


@pytest.mark.requires_cuda
def test_cuda_f32_takes_the_fma_kernels():
    """f32 launches the FMA kernels: head_dim 16, which the tensor-core
    kernels do not take, runs, and every head_dim of the FMA kernels
    holds 1e-4, which P in bf16 would not."""
    for D in FA.F32_HEAD_DIMS:
        q, k, v, do = _cuda_inputs(D, 1, 4, 2, 150, D, torch.float32)
        o, lse = FA.flash_attention_fwd(q, k, v)
        got = FA.flash_attention_bwd(q, k, v, o, lse, do)
        want_o, _ = FA.flash_attention_plain(q, k, v)
        want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do)
        _close(o, want_o)
        for g, w in zip(got, want):
            _close(g, w)


@pytest.mark.requires_cuda
def test_cuda_autograd_function_runs_the_backward_kernels():
    q, k, v, do = _cuda_inputs(1, 2, 8, 2, 100, 64, torch.float32)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    before = FA.flash_attention_bwd.launches
    o = FA.flash_attention(*leaves, window=40)
    got = torch.autograd.grad(o, leaves, do)
    assert FA.flash_attention_bwd.launches == before + 1
    _, lse = FA.flash_attention_fwd(q, k, v, window=40)
    want = FA.flash_attention_bwd_plain(q, k, v, o.detach(), lse, do,
                                        window=40)
    for g, w in zip(got, want):
        _close(g, w)
