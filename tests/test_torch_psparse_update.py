"""The port's psparse hash family and update (plain version and CPU
wrapper) against the JAX reference.

Hashes must agree bit for bit: rows and signs are uint32 multiply-shift
arithmetic, which the port does in int64 with 16-bit halves of each
multiplier. Float results are held at rtol 1e-5, atol 1e-5 *
max|reference| (f32 sums over the support slots, taken in another order
than the reference's one-hot tile products), as the sketch_update test
does. Inputs are drawn once with numpy and fed to both packages. The
CUDA kernel runs only on a card; its check here skips without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import psparse_update as J
from repro.sketches.psparse import PsparseProjections as JaxPsparse
from repro.sketches.update import proj_triple_increment as jax_increment
from repro.sketches.update import proj_triple_update as jax_proj_update
from repro_torch.interop import psparse_from_jax
from repro_torch.kernels import psparse_update as P
from repro_torch.sketches import (
    PsparseProjections, proj_triple_increment, proj_triple_update,
)
from test_torch_sketch_update import _chip_smoke_cases, plan_covers_once

RTOL = 1e-5
ATOL_REL = 1e-5
BETA = 0.9
MAX32 = 0xFFFFFFFF


def _coeffs(seed, extreme=False):
    """(3, 4) uint32 coefficients, multipliers odd as the reference
    forces them; ``extreme`` sets every coefficient to 0xFFFFFFFF."""
    if extreme:
        c = np.full((3, 4), MAX32, dtype=np.uint64)
    else:
        c = np.random.default_rng(seed).integers(0, 2**32, (3, 4),
                                                 dtype=np.uint64)
    c[:, 0] |= 1
    c[:, 2] |= 1
    return c.astype(np.uint32)


def _host(c):
    return tuple(tuple(int(v) for v in row) for row in c)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=RTOL,
        atol=ATOL_REL * max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("extreme", [False, True], ids=["random", "max"])
@pytest.mark.parametrize("T", [1, 37, 128, 1024, 65536, 70000])
def test_rows_and_signs_bit_exact(T, extreme):
    """T > 65536 makes the row product wrap in uint32."""
    c = _coeffs(T, extreme)
    m = J.psparse_dim(T, 9, 0.1)
    k = 33
    for i in range(3):
        want_rows = np.asarray(J.psparse_rows(jnp.asarray(c[i]), m, T))
        got_rows = P.psparse_rows(_host(c)[i], m, T).numpy()
        np.testing.assert_array_equal(got_rows, want_rows)
        assert 0 <= got_rows.min() and got_rows.max() < T
        want_sgn = np.asarray(J.psparse_signs(jnp.asarray(c[i]), m, k))
        np.testing.assert_array_equal(
            P.psparse_signs(_host(c)[i], m, k).numpy(), want_sgn)


@pytest.mark.parametrize("T,k,density", [(37, 9, 0.1), (64, 33, 0.5),
                                         (300, 1, 0.05)])
def test_geometry_and_dense_matrix(T, k, density):
    m = J.psparse_dim(T, k, density)
    assert P.psparse_dim(T, k, density) == m
    assert P.psparse_scale(T, m) == J.psparse_scale(T, m)
    c = _coeffs(T)
    for i in range(3):
        np.testing.assert_array_equal(
            P.psparse_dense_one(_host(c)[i], T, k, m).numpy(),
            np.asarray(J.psparse_dense_one(jnp.asarray(c[i]), T, k, m)))


def test_hash_params_are_odd_uint32():
    gen = torch.Generator().manual_seed(3)
    for row in P.psparse_hash_params(gen):
        assert len(row) == 4 and all(0 <= v <= MAX32 for v in row)
        assert row[0] & 1 and row[2] & 1


def _case(T, d, k, density, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(T, d), f(d, k), f(d, k), f(d, k), _coeffs(seed), f(k),
            J.psparse_dim(T, k, density))


# ragged T and d; k of 1, 9 and 33; density 1.0 puts m = T slots on T
# rows, so rows repeat (checked in the test)
CASES = [(37, 50, 9, 0.3), (64, 40, 33, 0.1), (20, 24, 1, 1.0),
         (129, 17, 9, 1.0)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("fn", ["ref", "wrapper"])
def test_update_matches_pallas_interpret_and_oracle(case, fn):
    T, d, k, density = case
    a, x, y, z, c, psi, m = _case(T, d, k, density, seed=T)
    jargs = [jnp.asarray(v) for v in (a, x, y, z, c, psi)]
    want_kernel = J.psparse_update(*jargs, beta=BETA, m=m, interpret=True)
    want_oracle = J.psparse_update_ref(*jargs, beta=BETA, m=m)
    targs = [torch.from_numpy(v) for v in (a, x, y, z)]
    f = P.psparse_update_ref if fn == "ref" else P.psparse_update
    got = f(*targs, _host(c), torch.from_numpy(psi), beta=BETA, m=m)
    for g, wk, wo in zip(got, want_kernel, want_oracle):
        _close(g.numpy(), wk)
        _close(g.numpy(), wo)
    if density == 1.0:
        rows = P.psparse_rows(_host(c)[0], m, T)
        assert len(set(rows.tolist())) < m, "no duplicate support row"


def test_bf16_activation_is_read_as_f32():
    a, x, y, z, c, psi, m = _case(37, 50, 9, 0.3, seed=5)
    a16 = torch.from_numpy(a).to(torch.bfloat16)
    got = P.psparse_update(a16, *map(torch.from_numpy, (x, y, z)), _host(c),
                           torch.from_numpy(psi), beta=BETA, m=m)
    want = J.psparse_update_ref(jnp.asarray(a16.float().numpy()),
                                *map(jnp.asarray, (x, y, z, c, psi)),
                                beta=BETA, m=m)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("k_active", [1, 5, 9])
@pytest.mark.parametrize("form", ["update", "increment"])
def test_proj_triple_psparse_branch(k_active, form):
    """The port's psparse branch against the reference's kernel branch
    (interpret) and its jnp gather path, with k_active < k_max."""
    T, d, k = 64, 40, 9
    a, x, y, z, c, psi, _ = _case(T, d, k, 0.2, seed=k_active)
    x[:, k_active:] = y[:, k_active:] = z[:, k_active:] = 0.0
    jproj = JaxPsparse(params=jnp.asarray(c), num_tokens=T, k_max=k,
                       density=0.2)
    proj = psparse_from_jax(c, T, k, 0.2)
    ours = proj_triple_update if form == "update" else proj_triple_increment
    ref = jax_proj_update if form == "update" else jax_increment
    got = ours(*map(torch.from_numpy, (x, y, z, a)), proj,
               torch.from_numpy(psi), BETA, torch.tensor(k_active))
    for use_kernel in (True, False):
        want = ref(*map(jnp.asarray, (x, y, z, a)), jproj, jnp.asarray(psi),
                   BETA, jnp.asarray(k_active), use_kernel=use_kernel)
        for g, w in zip(got, want):
            _close(g.numpy(), w)
    for g in got:
        assert not g[:, k_active:].any()


def test_projection_object_matches_reference():
    T, k = 100, 9
    c = _coeffs(7)
    ours = PsparseProjections(params=_host(c), num_tokens=T, k_max=k,
                              density=0.1)
    ref = JaxPsparse(params=jnp.asarray(c), num_tokens=T, k_max=k,
                     density=0.1)
    assert (ours.m, ours.scale) == (ref.m, ref.scale)
    for name in ("upsilon", "omega", "phi"):
        np.testing.assert_array_equal(ours[name].numpy(),
                                      np.asarray(ref[name]))
        np.testing.assert_array_equal(ours.rows(name).numpy(),
                                      np.asarray(ref.rows(name)))
        np.testing.assert_array_equal(ours.signs(name).numpy(),
                                      np.asarray(ref.signs(name)))


def test_cpu_wrapper_never_counts_a_launch():
    a, x, y, z, c, psi, m = _case(8, 16, 9, 0.5, seed=1)
    before = P.psparse_update.launches
    P.psparse_update(*map(torch.from_numpy, (a, x, y, z)), _host(c),
                     torch.from_numpy(psi), beta=BETA, m=m)
    assert P.psparse_update.launches == before


@pytest.mark.parametrize("case", _chip_smoke_cases("PSPARSE_CASES"),
                         ids=lambda c: "-".join(map(str, c)))
def test_launch_plan_covers_every_slot_once(case):
    """At every chip_smoke.py psparse case: the kernel its dtype and
    shape pick, and a split of the 3m support slots that counts each
    slot once."""
    _, T, d, k, dtype = case
    tc = P.uses_tensor_cores(T, d, getattr(torch, dtype))
    plan_covers_once(3 * P.psparse_dim(T, k, 0.1), d, tc)


def test_sign_tiles_with_alpha_after_match_reference():
    """The tensor-core kernel's arithmetic in plain PyTorch, for this
    test only: bf16 A read exactly, +-1 sign tiles (exact in bf16),
    A[rows]^T sgn summed in f32 and alpha applied after, against
    repro.kernels.psparse_update.psparse_update_ref at the LM's shape."""
    T, d, k = 1024, 2048, 17
    a, x, y, z, c, psi, m = _case(T, d, k, 0.1, seed=11)
    a16 = torch.from_numpy(a).to(torch.bfloat16)
    alpha = P.psparse_scale(T, m)
    got = []
    for i, s in enumerate((x, y, z)):
        rows = P.psparse_rows(_host(c)[i], m, T)
        sgn = P.psparse_signs(_host(c)[i], m, k).to(torch.bfloat16)
        inc = (a16.index_select(0, rows).float().T @ sgn.float()) * alpha
        if i == 2:
            inc = inc * torch.from_numpy(psi)[None, :]
        got.append(BETA * torch.from_numpy(s) + (1 - BETA) * inc)
    want = J.psparse_update_ref(jnp.asarray(a16.float().numpy()),
                                *map(jnp.asarray, (x, y, z, c, psi)),
                                beta=BETA, m=m)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_wrapper_rejects_what_the_kernel_cannot_take():
    a, x, y, z, c, psi, m = _case(8, 16, P.MAX_K + 1, 0.5, seed=2)
    args = [torch.from_numpy(v) for v in (a, x, y, z)]
    with pytest.raises(ValueError, match="range"):
        P.psparse_update(*args, _host(c), torch.from_numpy(psi), beta=BETA,
                         m=m)
    a, x, y, z, c, psi, m = _case(8, 16, 9, 0.5, seed=2)
    args = [torch.from_numpy(v) for v in (a, x, y, z)]
    tpsi = torch.from_numpy(psi)
    with pytest.raises(TypeError):
        P.psparse_update(args[0].double(), *args[1:], _host(c), tpsi,
                         beta=BETA, m=m)
    with pytest.raises(ValueError, match="contiguous"):
        P.psparse_update(args[0], args[1].T.contiguous().T, *args[2:],
                         _host(c), tpsi, beta=BETA, m=m)
    with pytest.raises(ValueError, match="support size"):
        P.psparse_update(*args, _host(c), tpsi, beta=BETA, m=9)
    with pytest.raises(ValueError, match="uint32"):
        P.psparse_update(*args, ((2**32, 1, 1, 1),) * 3, tpsi, beta=BETA,
                         m=m)


# (T, d, k, dtype) on the card: the trainer's and the serving path's
# shapes, then every tile edge of both kernels (d 50 on the FMA kernel in
# both types; d 136 and 1000 end inside a tensor-core tile; k of one, two
# and three 64-output warpgroups; T 8 gives fewer slots than a stage)
CUDA_CASES = [(128, 512, 33, torch.float32), (1024, 2048, 9, torch.bfloat16),
              (37, 50, 9, torch.float32)] + [
    (T, d, k, dt) for T in (8, 300) for d in (50, 136, 1000)
    for k in (1, 17, 64) for dt in (torch.float32, torch.bfloat16)]


def _cuda_case(T, d, k, dtype, density, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    a, x, y, z, c, psi, m = _case(T, d, k, density, seed=seed)
    dev = torch.device("cuda")
    args = [torch.from_numpy(v).to(dev) for v in (a, x, y, z)]
    args[0] = args[0].to(dtype)
    return args, _host(c), torch.from_numpy(psi).to(dev), m


def _cuda_check(args, c, tpsi, m):
    """Two calls against the plain version on the CPU, and equal bit for
    bit (the slot splits are summed in a fixed order)."""
    before = P.psparse_update.launches
    got = P.psparse_update(*args, c, tpsi, beta=BETA, m=m)
    again = P.psparse_update(*args, c, tpsi, beta=BETA, m=m)
    torch.cuda.synchronize()
    assert P.psparse_update.launches == before + 2
    want = P.psparse_update_ref(*[t.cpu() for t in args], c, tpsi.cpu(),
                                beta=BETA, m=m)
    for g, h, w in zip(got, again, want):
        # the kernels' 1e-4 (chip_smoke.py's TOL): sums in another order
        w = w.numpy()
        np.testing.assert_allclose(g.cpu().numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(float(np.abs(w).max()),
                                                   1e-30))
        assert torch.equal(g, h), "two calls differ"


@pytest.mark.requires_cuda
@pytest.mark.parametrize("T,d,k,dtype", CUDA_CASES)
def test_cuda_kernel_matches_plain_version(T, d, k, dtype):
    _cuda_check(*_cuda_case(T, d, k, dtype, 0.1, seed=T + d + k))

