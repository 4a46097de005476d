"""The EMA update kernels' stacked launch (one launch for E experts'
triples, as the "expert_in" nodes take it) on a CUDA device against the
plain versions: sketch_update on the tensor-core path (qwen3-moe's train
shape: E 128 experts of 160 rows at d 2048, bf16, k 17; a ragged one; a
split one) and on the FMA path (f32, and bf16 at T <= 64), psparse_update
on the tensor-core path (every row held) and on the FMA path over the
live slots (the train shape's 160 rows against a 2048-row binding).
Each stacked call launches once, equals two calls bit for bit, and each
expert's triple is the unstacked kernel's on that expert (within the
tolerance: the unstacked plan may split the rows another way).

Needs a CUDA device and nvcc: each test skips without one. This file
imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest \\
        tests/test_torch_stacked_update_cuda.py

Tolerance: rtol 1e-4, atol 1e-4 * max|plain|, as ``chip_smoke.py``
holds the kernels.
"""
import pytest
import torch

from repro_torch.kernels import psparse_update as P
from repro_torch.kernels import sketch_update as S

TOL = 1e-4
BETA = 0.9

# (E, rows, d, k, dtype)
DENSE = [(128, 160, 2048, 17, torch.bfloat16),   # qwen3-moe train, wgmma
         (4, 300, 136, 33, torch.bfloat16),      # ragged tiles, wgmma
         (2, 4096, 128, 17, torch.bfloat16),     # split rows, wgmma
         (3, 37, 50, 9, torch.float32),          # FMA
         (5, 8, 2048, 17, torch.bfloat16),       # FMA at T <= 64
         (2, 3000, 64, 9, torch.float32)]        # split rows, FMA
# (E, rows, d, k, dtype, num_tokens)
HASHED = [(128, 160, 2048, 17, torch.bfloat16, 2048),  # live slots, FMA
          (8, 300, 256, 17, torch.bfloat16, None),     # wgmma
          (3, 100, 50, 9, torch.float32, None)]        # FMA


def _gen(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(seed)


def _close(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL,
                                   atol=TOL * float(w.abs().max()))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("E,rows,d,k,dtype", DENSE)
def test_stacked_sketch_update_matches_plain_and_unstacked(E, rows, d, k,
                                                           dtype):
    gen = _gen(E + rows + d)
    f = lambda *s: torch.randn(s, generator=gen, device="cuda")
    a = f(E, rows, d).to(dtype)
    x, y, z, psi = f(E, d, k), f(E, d, k), f(E, d, k), f(E, k)
    ups, omg, phi = f(rows, k), f(rows, k), f(rows, k)
    before = S.sketch_update.launches
    got = S.sketch_update(a, x, y, z, ups, omg, phi, psi, beta=BETA)
    again = S.sketch_update(a, x, y, z, ups, omg, phi, psi, beta=BETA)
    torch.cuda.synchronize()
    assert S.sketch_update.launches == before + 2
    _close(got, S.sketch_update_ref(a, x, y, z, ups, omg, phi, psi, BETA))
    for g, h in zip(got, again):
        assert torch.equal(g, h), "two calls differ"
    for e in range(0, E, max(1, E // 4)):
        one = S.sketch_update(a[e], x[e], y[e], z[e], ups, omg, phi, psi[e],
                              beta=BETA)
        _close([g[e] for g in got], one)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("E,rows,d,k,dtype,num_tokens", HASHED)
def test_stacked_psparse_update_matches_plain_and_unstacked(E, rows, d, k,
                                                            dtype,
                                                            num_tokens):
    gen = _gen(E + rows)
    f = lambda *s: torch.randn(s, generator=gen, device="cuda")
    a = f(E, rows, d).to(dtype)
    x, y, z, psi = f(E, d, k), f(E, d, k), f(E, d, k), f(E, k)
    T = num_tokens or rows
    m = P.psparse_dim(T, k, 0.1)
    coeffs = P.psparse_hash_params(torch.Generator().manual_seed(rows))
    kw = dict(beta=BETA, m=m, num_tokens=num_tokens)
    before = P.psparse_update.launches
    got = P.psparse_update(a, x, y, z, coeffs, psi, **kw)
    again = P.psparse_update(a, x, y, z, coeffs, psi, **kw)
    torch.cuda.synchronize()
    assert P.psparse_update.launches == before + 2
    _close(got, P.psparse_update_ref(a, x, y, z, coeffs, psi, **kw))
    for g, h in zip(got, again):
        assert torch.equal(g, h), "two calls differ"
    for e in range(0, E, max(1, E // 4)):
        one = P.psparse_update(a[e], x[e], y[e], z[e], coeffs, psi[e], **kw)
        _close([g[e] for g in got], one)
