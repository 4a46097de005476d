"""The port's sketch_update (plain version and CPU wrapper) against the
JAX reference: the Pallas kernel in interpret mode and its jnp oracle.

Inputs are drawn once with numpy and fed to both packages. Tolerance:
rtol 1e-5, atol 1e-5 * max|reference| (f32 sums in different orders).
The CUDA kernel itself runs only on the card, where ``chip_smoke.py``
holds it against the plain version.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import sketch_update_ref as jax_ref
from repro.kernels.sketch_update import sketch_update as jax_kernel
from repro.sketches.update import ema_triple_update as jax_ema_update
from repro_torch.kernels.sketch_update import (
    FMA_MAX_T, FMA_ROWS, MAX_K, TC_ROWS, TC_TILE_D, launch_plan,
    sketch_update, sketch_update_ref, uses_tensor_cores,
)
from repro_torch.sketches.update import ema_triple_update

RTOL = 1e-5
ATOL_REL = 1e-5
BETA = 0.9

# (T, d, k): ragged T and d, the serving default k=9, the largest paper
# k=33, and a k that spans the kernel's four 16-wide chunks
SHAPES = [(37, 50, 9), (64, 40, 33), (20, 24, 64), (1, 3, 1)]


def _inputs(T, d, k, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return [f(T, d), f(d, k), f(d, k), f(d, k), f(T, k), f(T, k), f(T, k),
            f(k)]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=RTOL,
        atol=ATOL_REL * float(np.abs(want).max()))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("fn", ["ref", "wrapper"])
def test_matches_pallas_interpret_and_oracle(shape, fn):
    args = _inputs(*shape)
    want_kernel = jax_kernel(*map(jnp.asarray, args), beta=BETA,
                             interpret=True)
    want_oracle = jax_ref(*map(jnp.asarray, args), BETA)
    targs = [torch.from_numpy(a) for a in args]
    if fn == "ref":
        got = sketch_update_ref(*targs, BETA)
    else:
        got = sketch_update(*targs, beta=BETA)
    for g, wk, wo in zip(got, want_kernel, want_oracle):
        _close(g.numpy(), wk)
        _close(g.numpy(), wo)


def test_bf16_activation_is_read_as_f32():
    """bf16 A (the model's dtype at full width) is widened exactly."""
    args = _inputs(37, 50, 9)
    a16 = torch.from_numpy(args[0]).to(torch.bfloat16)
    rest = [torch.from_numpy(a) for a in args[1:]]
    got = sketch_update(a16, *rest, beta=BETA)
    want = jax_ref(jnp.asarray(a16.float().numpy()),
                   *map(jnp.asarray, args[1:]), BETA)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("k_active", [1, 5, 9])
def test_ema_update_masks_inactive_columns(k_active):
    """k_active < k_max through the canonical update: the port against
    the reference's kernel path (interpret) and its jnp path."""
    a, x, y, z, ups, omg, phi, psi = _inputs(37, 50, 9, seed=1)
    args = (x, y, z, a, ups, omg, phi, psi)
    got = ema_triple_update(*map(torch.from_numpy, args), BETA,
                            torch.tensor(k_active))
    for use_kernel in (True, False):
        want = jax_ema_update(*map(jnp.asarray, args), BETA,
                              jnp.asarray(k_active), use_kernel=use_kernel)
        for g, w in zip(got, want):
            _close(g.numpy(), w)
    for g in got:
        assert not g[:, k_active:].any()


def test_cpu_wrapper_never_counts_a_launch():
    before = sketch_update.launches, sketch_update.kernel_launches
    sketch_update(*map(torch.from_numpy, _inputs(8, 16, 9)), beta=BETA)
    assert (sketch_update.launches, sketch_update.kernel_launches) == before


def _chip_smoke_cases(name):
    """A case list of chip_smoke.py (its top level imports only the
    standard library)."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, name)


def plan_covers_once(rows, d, tensor_cores, sms=132):
    """The plan's splits partition [0, rows), each a whole number of the
    kernel's stages and none empty; on the tensor cores the blocks take
    at most one wave (one an SM) and at least half of it where the rows
    allow."""
    splits, per = launch_plan(rows, d, sms, tensor_cores)
    step = TC_ROWS if tensor_cores else FMA_ROWS
    assert per % step == 0 and splits >= 1
    seen = np.zeros(rows, dtype=int)
    for i in range(splits):
        lo, hi = i * per, min(rows, (i + 1) * per)
        assert lo < hi, "an empty split"
        seen[lo:hi] += 1
    assert (seen == 1).all()
    if tensor_cores:
        tiles = -(-d // TC_TILE_D)
        assert splits == 1 or tiles * splits <= sms
        assert 2 * splits > min(-(-rows // step), sms // tiles)
    return splits


@pytest.mark.parametrize("case", _chip_smoke_cases("SKETCH_UPDATE_CASES"),
                         ids=lambda c: "-".join(map(str, c)))
def test_launch_plan_covers_every_row_once(case):
    """At every chip_smoke.py case: the kernel its dtype and shape pick,
    and a T split that counts each row once."""
    _, T, d, k, dtype = case
    tc = uses_tensor_cores(T, d, getattr(torch, dtype))
    assert tc == (dtype == "bfloat16" and d % 8 == 0 and T > FMA_MAX_T)
    plan_covers_once(T, d, tc)


def test_wrapper_rejects_what_the_kernel_cannot_take():
    args = [torch.from_numpy(a) for a in _inputs(8, 16, MAX_K + 1)]
    with pytest.raises(ValueError, match="range"):
        sketch_update(*args, beta=BETA)
    args = [torch.from_numpy(a) for a in _inputs(8, 16, 9)]
    with pytest.raises(TypeError):
        sketch_update(args[0].double(), *args[1:], beta=BETA)
    with pytest.raises(ValueError, match="contiguous"):
        sketch_update(args[0], args[1].T.contiguous().T, *args[2:],
                      beta=BETA)
    with pytest.raises(ValueError, match="shape"):
        sketch_update(args[0], *args[1:4], args[4][:4], *args[5:],
                      beta=BETA)


@pytest.mark.parametrize("k_active", [3, 9])
def test_increment_then_apply_is_the_update(k_active):
    """``ema_triple_increment`` against the reference's (kernel and jnp
    paths), and ``ema_apply_increment`` of it against the update."""
    from repro.sketches.update import ema_apply_increment as jax_apply
    from repro.sketches.update import ema_triple_increment as jax_increment
    from repro_torch.sketches.update import (
        ema_apply_increment, ema_triple_increment,
    )
    a, x, y, z, ups, omg, phi, psi = _inputs(37, 50, 9, seed=2)
    x[:, k_active:] = y[:, k_active:] = z[:, k_active:] = 0.0
    args = (x, y, z, a, ups, omg, phi, psi)
    ka = torch.tensor(k_active)
    got = ema_triple_increment(*map(torch.from_numpy, args), BETA, ka)
    for use_kernel in (True, False):
        want = jax_increment(*map(jnp.asarray, args), BETA,
                             jnp.asarray(k_active), use_kernel=use_kernel)
        for g, w in zip(got, want):
            _close(g.numpy(), w)
    upd = ema_triple_update(*map(torch.from_numpy, args), BETA, ka)
    for s, inc, u in zip((x, y, z), got, upd):
        applied = ema_apply_increment(torch.from_numpy(s), inc, BETA, ka)
        want = jax_apply(jnp.asarray(s), jnp.asarray(inc.numpy()), BETA,
                         jnp.asarray(k_active))
        _close(applied.numpy(), want)
        _close(applied.numpy(), u.numpy())


@pytest.mark.parametrize("rows", [5, 8])
def test_pad_activation_rows_and_row_binding(rows):
    from repro.sketches.update import pad_activation_rows as jax_pad
    from repro_torch.sketches import (
        PsparseProjections, pad_activation_rows, proj_num_tokens,
    )
    a = _inputs(rows, 6, 3)[0]
    got = pad_activation_rows(torch.from_numpy(a), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_pad(
        jnp.asarray(a), 8)))
    with pytest.raises(ValueError, match="num_tokens"):
        pad_activation_rows(torch.from_numpy(a), rows - 1)
    assert proj_num_tokens({"omega": torch.zeros(8, 3)}) == 8
    assert proj_num_tokens(PsparseProjections(((1, 0, 1, 0),) * 3, 8,
                                              3)) == 8


def split_products(a, ups, omg, phi, psi, x, y, z, beta):
    """The tensor-core kernel's arithmetic in plain PyTorch, for this
    test only: bf16 A read exactly, each f32 projection carried as hi =
    bf16(P) and lo = bf16(P - hi), A^T hi + A^T lo summed in f32, then
    the epilogue. (f32 A takes the FMA kernel, whose products are the
    plain version's f32 ones.)"""
    at = a.float().T

    def prod(p, keep_lo=True):
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        return at @ hi + (at @ lo if keep_lo else 0.0)

    return (beta * x + (1 - beta) * prod(ups),
            beta * y + (1 - beta) * prod(omg),
            beta * z + (1 - beta) * prod(phi) * psi[None, :]), prod


@pytest.mark.parametrize("shape", [(1024, 2048, 17)] + SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_split_arithmetic_matches_reference(shape):
    """hi/lo of P on bf16 A against repro.kernels.ref.sketch_update_ref
    at the reference tolerance; at the LM's shape, dropping the lo
    product fails it, so the tolerance tells the split from rounding."""
    a, x, y, z, ups, omg, phi, psi = _inputs(*shape, seed=3)
    a = torch.from_numpy(a).to(torch.bfloat16)
    t = [torch.from_numpy(v) for v in (ups, omg, phi, psi, x, y, z)]
    got, prod = split_products(a, *t, BETA)
    want = jax_ref(jnp.asarray(a.float().numpy()), *map(jnp.asarray, (
        x, y, z, ups, omg, phi, psi)), BETA)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    if shape == (1024, 2048, 17):
        no_lo = BETA * t[4] + (1 - BETA) * prod(t[0], keep_lo=False)
        with pytest.raises(AssertionError):
            _close(no_lo.numpy(), want[0])


def test_lib_path_covers_included_headers(tmp_path, monkeypatch):
    """A library's name hashes its source and every csrc header the
    source includes, followed through the headers: editing a header
    rebuilds each library that includes it, and only those."""
    import shutil

    from repro_torch.kernels import _build
    for path in _build.CSRC.iterdir():
        shutil.copy(path, tmp_path / path.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.sources("sketch_update")] == [
        "sketch_update.cu", "ema_update.cuh", "hopper.cuh"]
    names = ("sketch_update", "psparse_update", "flash_attention",
             "csvec_insert")
    before = {n: _build.lib_path(n) for n in names}
    header = tmp_path / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build.lib_path(n) for n in names}
    assert [after[n] != before[n] for n in names] == [True, True, True,
                                                       False]
