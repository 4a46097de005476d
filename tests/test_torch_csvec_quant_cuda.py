"""The csvec_quant kernel on a CUDA device against its plain version on
the same device, in both forms (q, scale, dhat and resid; and
``dhat_only``): tables of a few counters a row (a block a row), ragged
widths that take the 4-byte path (c not a multiple of 4, and a view off
16-byte alignment), rows spread over the card with their parts in
registers and shared memory, a row longer than those hold (the rest
through L2), the LM train step's 5 x 2^23, and rows holding NaN, inf and
-inf.

Needs a CUDA device and nvcc: each test skips without one. This file
imports neither JAX nor the JAX package, so it runs where only the port
is installed:

    PYTHONPATH=src python -m pytest -q --noconftest \
        tests/test_torch_csvec_quant_cuda.py

Tolerance: none for q, scale and dhat, which must equal the plain
version's bit for bit with NaN in the same places (the kernel divides,
rounds and multiplies as the plain version does, and the row's amax is
exact); resid within one ulp of the row's amax where finite, NaN in the
same places.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import csvec_quant as KQ

# a row amax whose quotient by 127 and product with fl(1/127) round
# apart (1 + 60 ulp, times 64), planted as a row's last entry
SPLIT_AMAX = 64 + 60 * 2**-17

CASES = [  # (r, c, kind)
    (5, 128, "normal"), (4, 128, "normal"),      # CS_CASES: a block a row
    (5, 1001, "normal"), (3, 1000, "normal"),    # ragged
    (2, 2**22, "normal"), (2, 2**22 - 1, "normal"),   # parts over tiles
    (1, 2**24, "normal"),                        # past the chip: L2
    (5, 2**23, "normal"),                        # the LM train step
    (5, 128, "nan"), (5, 128, "inf"), (5, 1001, "nan"),
    (5, 2**20, "nan"), (5, 2**20, "inf"), (5, 2**23, "nan_inf"),
]


def _table(r, c, kind, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(seed)
    t = (rng.standard_normal((r, c))
         * rng.uniform(0.01, 10, (r, 1))).astype(np.float32)
    t[0] /= max(1.0, float(np.abs(t[0]).max()))
    t[0, -1] = SPLIT_AMAX
    if r > 2:
        t[2] = 0.0                                   # scale 0
    if kind in ("nan", "nan_inf"):
        t[1, c // 2] = np.nan
        t[r - 1, c - 1] = np.nan                     # the row's last entry
    if kind in ("inf", "nan_inf"):
        t[r - 1, 0] = np.inf
        t[min(3, r - 1), c // 3] = -np.inf
        t[1, c // 2 + 1] = np.inf
    return torch.from_numpy(t).cuda()


def _poison(r, c):
    """Leave freed blocks of the outputs' sizes full of 0x7f bytes, so an
    element the kernel does not write cannot pass as a stale result."""
    bufs = [torch.full((r, c), 0x7f, dtype=torch.int8, device="cuda")]
    bufs += [torch.full((r, c), 0x7f7f7f7f, dtype=torch.int32,
                        device="cuda") for _ in range(3)]
    del bufs


def _bits_equal(got, want):
    """Equal bit for bit, with NaN in the same places."""
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def _check(got, want, table, full):
    q, scale, dhat, resid = got
    wq, ws, wd, wr = want
    assert _bits_equal(scale, ws) and _bits_equal(dhat, wd)
    if not full:
        assert q is None and resid is None
        return
    assert q.dtype == torch.int8 and torch.equal(q, wq)
    nan = torch.isnan(wr)
    assert torch.equal(torch.isnan(resid), nan)
    amax = table.abs().amax(1, keepdim=True)
    ulp = torch.nextafter(amax, torch.full_like(amax, float("inf"))) - amax
    fin = ~nan & torch.isfinite(ulp).expand_as(wr)
    assert bool(((resid - wr).abs() <= ulp)[fin].all())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("r,c,kind", CASES)
def test_cuda_quant_equals_plain_version(r, c, kind, full):
    table = _table(r, c, kind, seed=r * 7 + c)
    want = KQ.csvec_quant_ref(table)
    split = np.float32(SPLIT_AMAX)
    assert float(table[0].abs().max()) == SPLIT_AMAX
    assert split / np.float32(127) != split * (np.float32(1) / np.float32(127))
    before = KQ.csvec_quant.launches
    for _ in range(2):       # the row words reset themselves between calls
        _poison(r, c)
        got = KQ.csvec_quant(table, dhat_only=not full)
        torch.cuda.synchronize()
        _check(got, want, table, full)
    assert KQ.csvec_quant.launches == before + 2
    if kind != "normal":
        bad = ~torch.isfinite(table).all(1)
        assert bool(torch.isnan(got[2][bad]).all())
        # the NaN codes: the card's plain version converts them as the
        # CPU's does
        assert torch.equal(want[0].cpu(), KQ.csvec_quant_ref(table.cpu())[0])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("full", [True, False])
def test_cuda_quant_takes_a_view_off_16_byte_alignment(full):
    r, c = 5, 2**16
    table = _table(r, c, "nan", seed=3)
    flat = torch.zeros(r * c + 1, device="cuda")
    flat[1:] = table.reshape(-1)
    view = flat[1:].view(r, c)
    assert view.data_ptr() % 16
    got = KQ.csvec_quant(view, dhat_only=not full)
    torch.cuda.synchronize()
    _check(got, KQ.csvec_quant_ref(table), table, full)


@pytest.mark.requires_cuda
def test_cuda_quant_on_two_streams():
    """Each stream keeps its own row words: calls on a second stream,
    then on the first again, stay exact."""
    r, c = 5, 2**20
    table = _table(r, c, "normal", seed=5)
    want = KQ.csvec_quant_ref(table)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got_side = KQ.csvec_quant(table)
    torch.cuda.current_stream().wait_stream(side)
    got = KQ.csvec_quant(table)
    torch.cuda.synchronize()
    _check(got_side, want, table, True)
    _check(got, want, table, True)
