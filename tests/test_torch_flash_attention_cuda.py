"""The flash attention kernels on a CUDA device against their plain
versions, at every compiled head_dim in f32 and in bf16, in the model's
layout ((B, S, H, D) storage read as (B, H, S, D)), at lengths that
span several 64-row tiles, end ragged, or pass a window, with the dk/dv
pass split over query-head slices and not.

Needs a CUDA device and nvcc: each test skips without one. This file
imports neither JAX nor the JAX package, so it runs where only the port
is installed:

    PYTHONPATH=src python -m pytest -q --noconftest \
        tests/test_torch_flash_attention_cuda.py

Tolerances, relative to the largest plain value: f32 rtol and atol 1e-4
(the sums run in another order); bf16 o, dq, dk and dv 1e-2 (both sides
compute in f32 from the same bf16 inputs and round once to bf16, whose
ulp is 2^-7 of a value), lse (f32 in both types) 1e-4.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA

CASES = [  # (B, Hq, Hkv, S, D, window, dtype)
    (2, 4, 2, 37, 16, None, torch.float32),
    (1, 4, 2, 80, 16, 32, torch.float32),
    (2, 4, 2, 37, 16, None, torch.bfloat16),
    (2, 8, 2, 130, 64, None, torch.float32),
    (2, 8, 2, 130, 64, None, torch.bfloat16),
    (1, 4, 1, 200, 128, 64, torch.float32),
    (1, 4, 1, 200, 128, 64, torch.bfloat16),
    (1, 4, 2, 96, 160, None, torch.float32),
    (1, 4, 2, 96, 160, None, torch.bfloat16),
    # enough KV tiles and heads that the dk/dv pass takes one slice of
    # each group (the cases above split it and sum partials)
    (2, 4, 4, 2100, 16, 300, torch.float32),
    (4, 4, 4, 1100, 64, None, torch.bfloat16),
]


def _cuda_inputs(seed, B, Hq, Hkv, S, D, dtype):
    """q, k, v, do from numpy, on the card in the model's layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, S, h, D)).astype(
        np.float32)).to("cuda", dtype).transpose(1, 2)
        for h in (Hq, Hkv, Hkv, Hq)]


def _close(got, want, tol):
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * scale)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,D,window,dtype", CASES)
def test_cuda_kernels_match_plain_versions(B, Hq, Hkv, S, D, window, dtype):
    q, k, v, do = _cuda_inputs(S + D, B, Hq, Hkv, S, D, dtype)
    before = (FA.flash_attention_fwd.launches, FA.flash_attention_bwd.launches)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = FA.dkdv_splits(B, Hkv, S, Hq // Hkv, sms)
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
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    _close(o, want_o, tol)
    _close(lse, want_lse, 1e-4)
    for g, w in zip(got, want):
        _close(g, w, tol)


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
        _close(g, w, 1e-4)
