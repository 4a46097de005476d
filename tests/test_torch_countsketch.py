"""The port's count-sketch pieces against the JAX reference, on the CPU:
hashes, the insert / top-k / quantisation plain versions (the kernels'
CPU path) against the reference's Pallas kernels in interpret mode and
its jnp oracles, and the compression modules.

Inputs are made with numpy from a seed and fed to both packages; the
hash coefficients are the reference's. Tolerances:
  * buckets, signs, top-k indices and values (given the same table),
    int8 codes, scales and dequantised tables: exact;
  * insert: rtol 1e-6, atol 1e-6 * max|table| (f32 sums in another
    order);
  * quantisation residual: one ulp of the row's amax (the Pallas
    kernel's FMA);
  * flat compression state: u and v exact away from the sent
    coordinates; the update exact at them (the same f32 operations).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.countsketch import csvec as J
from repro.kernels.csvec_insert import csvec_insert as jax_insert
from repro.kernels.csvec_quant import csvec_quant as jax_quant
from repro.kernels.csvec_quant import csvec_quant_ref as jax_quant_ref
from repro.kernels.csvec_topk import csvec_topk as jax_topk
from repro.kernels.ref import csvec_insert_ref as jax_insert_ref
from repro.kernels.ref import csvec_topk_ref as jax_topk_ref
from repro.optim import compression as JC
from repro.optim import sketched_sgd as JS
from repro_torch.countsketch import csvec as T
from repro_torch.interop import csvec_params_from_jax
from repro_torch.kernels import csvec_insert as KI
from repro_torch.kernels import csvec_quant as KQ
from repro_torch.kernels import csvec_topk as KT
from repro_torch.optim import compression as TC
from repro_torch.optim import sketched_sgd as TS


def _coeffs(rows, seed, ones=False):
    if ones:
        p = np.full((4, rows), 0xFFFFFFFF, dtype=np.uint32)
    else:
        rng = np.random.default_rng(seed)
        p = rng.integers(0, 2**32, (4, rows), dtype=np.uint64).astype(
            np.uint32)
        p[0] |= 1
        p[2] |= 1
    return p, csvec_params_from_jax(p)


def _table(r, c, n, seed, ties=False):
    """A table holding the sketch of a heavy-tailed vector; with ``ties``
    small integers instead, whose medians tie at many coordinates."""
    rng = np.random.default_rng(seed)
    p, tp = _coeffs(r, seed + 1)
    if ties:
        return rng.integers(-4, 5, (r, c)).astype(np.float32), p, tp
    vec = (rng.standard_normal(n) * rng.pareto(2.0, n)).astype(np.float32)
    table = np.array(J.insert(J.CSVec(
        table=jnp.zeros((r, c), jnp.float32), params=jnp.asarray(p), dim=n),
        jnp.asarray(vec)).table)
    return table, p, tp


@pytest.mark.parametrize("cols", [1, 128, 2**23])
@pytest.mark.parametrize("ones", [False, True])
def test_hashes_bit_exact(cols, ones):
    p, tp = _coeffs(5, cols, ones)
    idx = np.concatenate([np.arange(5000), 2**31 + np.arange(-50, 50),
                          2**32 - 1 - np.arange(50)]).astype(np.uint32)
    ti = torch.from_numpy(idx.astype(np.int64))
    np.testing.assert_array_equal(
        T.hash_buckets(tp, cols, ti).numpy(),
        np.asarray(J.hash_buckets(jnp.asarray(p), cols, jnp.asarray(idx))))
    np.testing.assert_array_equal(
        T.hash_signs(tp, ti).numpy(),
        np.asarray(J.hash_signs(jnp.asarray(p), jnp.asarray(idx))))


def test_hash_params_are_odd_uint32():
    tp = T.hash_params(torch.Generator().manual_seed(3), 6)
    assert len(tp) == 4 and all(len(row) == 6 for row in tp)
    assert all(0 <= c < 2**32 for row in tp for c in row)
    assert all(c & 1 for c in tp[0] + tp[2])
    with pytest.raises(ValueError, match="power of two"):
        T.make_csvec(torch.Generator(), 10, 3, 100)


@pytest.mark.parametrize("r,c,n", [(5, 128, 1000), (4, 256, 3001),
                                   (1, 1, 50), (3, 512, 70000)])
def test_insert_matches_pallas_and_oracle(r, c, n):
    rng = np.random.default_rng(n)
    p, tp = _coeffs(r, n)
    vec = rng.standard_normal(n).astype(np.float32)
    table = rng.standard_normal((r, c)).astype(np.float32)  # adds onto it
    got = KI.csvec_insert(torch.from_numpy(table), tp, torch.from_numpy(vec))
    chunked = KI.csvec_insert_ref(torch.from_numpy(table), tp,
                                  torch.from_numpy(vec), chunk=97)
    for want in (jax_insert(jnp.asarray(table), jnp.asarray(p),
                            jnp.asarray(vec), interpret=True),
                 jax_insert_ref(jnp.asarray(table), jnp.asarray(p),
                                jnp.asarray(vec))):
        want = np.asarray(want)
        for g in (got, chunked):
            np.testing.assert_allclose(g.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
    torch.testing.assert_close(got, chunked, rtol=0, atol=0)


def test_insert_at_and_merge_match_reference():
    r, c, n = 3, 64, 400
    rng = np.random.default_rng(7)
    p, tp = _coeffs(r, 7)
    idx = rng.choice(n, 50, replace=False).astype(np.int32)
    vals = rng.standard_normal(50).astype(np.float32)
    zero = T.CSVec(table=torch.zeros(r, c), params=tp, dim=n)
    jzero = J.CSVec(table=jnp.zeros((r, c)), params=jnp.asarray(p), dim=n)
    got = T.insert_at(zero, torch.from_numpy(idx.astype(np.int64)),
                      torch.from_numpy(vals))
    want = J.insert_at(jzero, jnp.asarray(idx), jnp.asarray(vals))
    np.testing.assert_allclose(got.table.numpy(), np.asarray(want.table),
                               rtol=1e-6, atol=1e-6)
    merged = T.merge(got, got)
    np.testing.assert_array_equal(merged.table.numpy(),
                                  2 * got.table.numpy())
    with pytest.raises(ValueError, match="mismatched"):
        T.merge(got, dataclasses.replace(got, dim=n + 1))


@pytest.mark.parametrize("r", [4, 5])
def test_query_and_unsketch_match_reference(r):
    n = 900
    table, p, tp = _table(r, 128, n, seed=r)
    cs = T.CSVec(table=torch.from_numpy(table), params=tp, dim=n)
    jcs = J.CSVec(table=jnp.asarray(table), params=jnp.asarray(p), dim=n)
    np.testing.assert_array_equal(T.query_all(cs).numpy(),
                                  np.asarray(J.query_all(jcs)))
    np.testing.assert_array_equal(T.unsketch(cs, 17).numpy(),
                                  np.asarray(J.unsketch(jcs, 17)))


def test_even_r_median_is_the_midpoint_not_the_lower_middle():
    est = torch.tensor([[1.0, -4.0], [3.0, 2.0], [2.0, 0.0], [7.0, 1.0]])
    np.testing.assert_array_equal(T.median_rows(est).numpy(), [2.5, 0.5])
    assert float(torch.median(est[:, 0])) == 2.0      # lower middle


def _check_topk(r, k, chunk, n, ties, wants):
    table, p, tp = _table(r, 128, n, seed=10 + r, ties=ties)
    vals, idx = KT.csvec_topk_ref(torch.from_numpy(table), tp, n, k, chunk)
    for a, b in zip(KT.csvec_topk(torch.from_numpy(table), tp, n, k),
                    (vals, idx)):
        assert torch.equal(a, b)        # the wrapper: one plain chunk
    assert idx.dtype == torch.int64 and len(idx) == min(k, n)
    jt, jp = jnp.asarray(table), jnp.asarray(p)
    for wv, wi in wants(jt, jp):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(wv))
    mags = np.abs(vals.numpy())
    if ties:
        assert len(set(mags.tolist())) < len(mags)     # ties were selected


@pytest.mark.parametrize("r", [4, 5])
@pytest.mark.parametrize("k,chunk,ties", [(5, 256, False), (64, 16384, True),
                                          (300, 100, True),
                                          (1000, 128, False)])
def test_topk_matches_oracles(r, k, chunk, ties):
    """Exact indices and values against the reference's dense oracle and
    its streaming top-k, ties and even r included; k > chunk exercises
    the plain version's concatenate-and-sort merge."""
    n = 1000
    _check_topk(r, k, chunk, n, ties, lambda jt, jp: [
        jax_topk_ref(jt, jp, n, k),
        J.topk_streaming(J.CSVec(table=jt, params=jp, dim=n), k,
                         chunk=chunk)])


@pytest.mark.parametrize("r", [4, 5])
def test_topk_matches_pallas_interpret(r):
    n, k = 600, 40
    _check_topk(r, k, 97, n, True, lambda jt, jp: [
        jax_topk(jt, jp, dim=n, k=k, chunk=256, interpret=True)])


def test_topk_ties_break_to_the_smaller_index():
    table = np.ones((1, 2), np.float32)
    p = np.array([[1], [0], [1], [0]], np.uint32)  # bucket 0, sign +
    _, idx = KT.csvec_topk_ref(torch.from_numpy(table),
                               csvec_params_from_jax(p), 40, 7, chunk=8)
    np.testing.assert_array_equal(idx.numpy(), np.arange(7))


@pytest.mark.parametrize("c", [128, 4096])
def test_quant_matches_oracle_and_pallas(c):
    """q, scale and dhat equal the reference's jnp oracle bit for bit
    (IEEE division by 127); resid is within one ulp of the row's amax.
    The reference's Pallas kernel, in interpret mode, takes scale as
    amax times the reciprocal of 127, one ulp off the oracle on some
    rows (ROADMAP C): on the rows where their scales agree, the port
    equals the kernel too."""
    rng = np.random.default_rng(c)
    table = (rng.standard_normal((5, c))
             * rng.uniform(0.01, 100, (5, 1))).astype(np.float32)
    table[2] = 0.0                                  # all-zero row
    table[3, :4] = [127.5, -127.5, 0.5, -0.5]       # ties at .5
    q, scale, dhat, resid = KQ.csvec_quant(torch.from_numpy(table))
    assert q.dtype == torch.int8 and float(scale[2]) == 0.0
    assert not bool(q[2].any())
    ulp = np.spacing(np.abs(table).max(1, keepdims=True))
    wq, ws, wd, wr = (np.asarray(w)
                      for w in jax_quant_ref(jnp.asarray(table)))
    np.testing.assert_array_equal(q.numpy(), wq)
    np.testing.assert_array_equal(scale.numpy(), ws)
    np.testing.assert_array_equal(dhat.numpy(), wd)
    assert np.all(np.abs(resid.numpy() - wr) <= ulp)
    np.testing.assert_array_equal((dhat + resid).numpy(), table)
    kq, ks, kd, kr = (np.asarray(w) for w in jax_quant(jnp.asarray(table),
                                                       interpret=True))
    np.testing.assert_allclose(ks, ws, rtol=2**-23, atol=0)
    same = ks == ws
    np.testing.assert_array_equal(q.numpy()[same], kq[same])
    np.testing.assert_array_equal(dhat.numpy()[same], kd[same])
    assert np.all(np.abs(resid.numpy() - kr)[same] <= ulp[same])


@pytest.mark.parametrize("kind", ["nan", "inf", "nan_and_inf"])
def test_quant_of_a_nonfinite_table_matches_oracle_and_pallas(kind):
    """A NaN in a row makes its amax, scale and dhat NaN and its codes
    clamp(round(t)) with NaN codes 0; an inf makes the row's scale inf,
    its codes 0 and its dhat NaN. The plain version, the reference's
    oracle and its Pallas kernel in interpret mode agree: q exactly,
    scale and dhat equal with NaN in the same places (the kernel on the
    rows where its scale agrees with the oracle's, as above), resid
    within one ulp of the row's amax where finite. ``dhat_only`` gives
    the same scale and dhat."""
    rng = np.random.default_rng(11)
    table = rng.standard_normal((5, 256)).astype(np.float32)
    if kind in ("nan", "nan_and_inf"):
        table[2, 17] = np.nan
        table[4, 255] = np.nan                      # the row's last entry
    if kind in ("inf", "nan_and_inf"):
        table[3, 0] = np.inf
        table[1, 100] = -np.inf
        table[2, 18] = np.inf                       # beside the NaN
    t = torch.from_numpy(table)
    q, scale, dhat, resid = KQ.csvec_quant(t)
    none_q, scale1, dhat1, none_r = KQ.csvec_quant(t, dhat_only=True)
    assert none_q is None and none_r is None
    assert _same(scale1, scale)
    assert _same(dhat1, dhat)
    bad = ~np.isfinite(table).all(1)
    assert np.isnan(dhat.numpy()[bad]).all() and not np.isnan(
        dhat.numpy()[~bad]).any()
    wq, ws, wd, wr = (np.asarray(w)
                      for w in jax_quant_ref(jnp.asarray(table)))
    np.testing.assert_array_equal(q.numpy(), wq)
    np.testing.assert_array_equal(scale.numpy(), ws)   # NaN where NaN
    np.testing.assert_array_equal(dhat.numpy(), wd)
    fin = np.isfinite(wr)
    np.testing.assert_array_equal(np.isfinite(resid.numpy()), fin)
    ulp = np.broadcast_to(np.spacing(np.abs(table).max(1, keepdims=True)),
                          table.shape)
    assert np.all(np.abs(resid.numpy() - wr)[fin] <= ulp[fin])
    kq, ks, kd, _ = (np.asarray(w) for w in jax_quant(jnp.asarray(table),
                                                      interpret=True))
    same = (ks == ws) | (np.isnan(ks) & np.isnan(ws))
    assert same[bad].all()
    np.testing.assert_array_equal(q.numpy()[same], kq[same])
    np.testing.assert_array_equal(dhat.numpy()[same], kd[same])


@pytest.mark.parametrize("r,c,vec,blocks", [
    (5, 2**23, 4, 132),          # the LM train step: a row over the card
    (5, 128, 4, 132), (4, 128, 4, 132),    # CS_CASES: a block a row
    (5, 1001, 1, 132), (2, 2**22, 4, 132), (2, 2**22 - 1, 1, 132),
    (1, 2**24, 4, 132),          # past the registers and shared memory
    (8, 2**20, 4, 132), (3, 100_003, 1, 264), (1, 1, 1, 132),
    (5, 2**23, 4, 1)])
def test_quant_plan_covers_every_element_once_with_its_handoff(r, c, vec,
                                                               blocks):
    """Block b takes rows b // bpr, then every conc-th after it, and
    elements [p part, (p + 1) part) of each (p = b % bpr): every element
    of the table once, each block some. The bpr blocks of a row take the
    same rows in the same order, so every row's handoff counts bpr
    arrivals before any of them goes on, and they co-reside where a row
    has several. A part stays on the chip (a tile in registers, the
    rest in shared memory) unless the row needs more blocks than the
    card has."""
    plan = KQ.launch_plan(r, c, vec, blocks)
    assert plan.part % vec == 0 and plan.smem % vec == 0
    assert 0 <= plan.smem <= KQ.SMEM_ELEMS and 1 <= plan.conc <= r
    assert plan.bpr * plan.part >= c > (plan.bpr - 1) * plan.part
    if plan.bpr > 1:
        assert plan.grid <= blocks
    rows_of = {b: list(range(b // plan.bpr, r, plan.conc))
               for b in range(plan.grid)}
    for j in range(r):
        takers = [b for b, rows in rows_of.items() if j in rows]
        assert len(takers) == plan.bpr            # the row's arrivals
        assert len({tuple(rows_of[b]) for b in takers}) == 1
        spans = sorted((b % plan.bpr * plan.part,
                        min(c, (b % plan.bpr + 1) * plan.part))
                       for b in takers)
        assert spans[0][0] == 0 and spans[-1][1] == c
        assert all(a[1] == b[0] and a[0] < a[1]
                   for a, b in zip(spans, spans[1:]))
    on_chip = plan.tile + plan.smem >= plan.part
    assert on_chip or -(-c // (plan.tile + KQ.SMEM_ELEMS)) >= blocks
    if (r, c) == (5, 2**23) and blocks == 132:
        assert (plan.conc, plan.bpr, plan.part) == (1, 132, 63_552)
    if c == 128:
        assert (plan.conc, plan.bpr, plan.smem) == (r, 1, 0)


def test_quantize_rows_matches_reference():
    x = np.random.default_rng(0).standard_normal((3, 4, 9)).astype(
        np.float32)
    q, s = T.quantize_rows(torch.from_numpy(x))
    wq, ws = J.quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(T.dequantize_rows(q, s).numpy(),
                                  np.asarray(J.dequantize_rows(wq, ws)))
    cs = T.CSVec(table=torch.zeros(5, 64), params=((1,) * 5,) * 4, dim=9)
    jcs = J.CSVec(table=jnp.zeros((5, 64)), params=jnp.ones((4, 5),
                                                            jnp.uint32), dim=9)
    assert T.table_bytes(cs) == J.table_bytes(jcs)
    assert T.quantized_table_bytes(cs) == J.quantized_table_bytes(jcs)


def test_cpu_wrappers_count_no_launch():
    table, _, tp = _table(3, 128, 300, seed=1)
    t = torch.from_numpy(table)
    before = (KI.csvec_insert.launches, KT.csvec_topk.launches,
              KQ.csvec_quant.launches)
    KI.csvec_insert(t, tp, torch.zeros(300))
    KT.csvec_topk(t, tp, 300, 5)
    KQ.csvec_quant(t)
    assert (KI.csvec_insert.launches, KT.csvec_topk.launches,
            KQ.csvec_quant.launches) == before


def test_wrappers_reject_what_the_kernels_cannot_take():
    t = torch.zeros(3, 128)
    _, tp = _coeffs(3, 0)
    with pytest.raises(ValueError, match="power of two"):
        KI.csvec_insert(torch.zeros(3, 100), tp, torch.zeros(4))
    with pytest.raises(ValueError, match="r=9"):
        KQ.csvec_quant(torch.zeros(9, 128))
    with pytest.raises(ValueError, match="params"):
        KI.csvec_insert(t, _coeffs(2, 0)[1], torch.zeros(4))
    with pytest.raises(ValueError, match="float32"):
        KI.csvec_insert(t, tp, torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="int32"):
        KI._check(t.to("meta"), tp, torch.empty(2**31, device="meta"))
    with pytest.raises(ValueError, match="k=1025"):
        KT.csvec_topk(t, tp, 5000, 1025)


@pytest.mark.parametrize("n,r,c", [
    (1_100_048_384, 5, 2**23),   # tinyllama-1.1b's LM train step
    (1000, 5, 128), (65_537, 4, 2**12), (0, 1, 1), (1, 1, 1),
    (2**31 - 1, 1, 2**30), (50_000_000, 8, 2**20)])
def test_insert_plan_covers_every_element_within_its_scratch(n, r, c):
    plan = KI.insert_plan(n, r, c)
    assert plan.scratch_bytes <= KI.SCRATCH_CAP
    assert plan.chunk % KI.TILE == 0 and 0 < plan.chunk < 2**31
    # the chunks [k * chunk, (k + 1) * chunk) hold each i < n once
    assert plan.chunks * plan.chunk >= n > (plan.chunks - 1) * plan.chunk
    assert plan.kernels == 2 * plan.chunks
    assert plan.nbins << plan.bin_bits == c and plan.nbins <= KI.MAX_BINS
    assert plan.bin_bits <= max(KI.BIN_BITS, c.bit_length() - 13)
    if n == 1_100_048_384:        # 21 chunks of 256 bins a row
        assert (plan.nbins, plan.chunks) == (256, 21)


def _emulate_insert(table, params, vec, plan):
    """The kernels' decomposition on the CPU: per chunk, per tile of TILE
    elements and per row, the records sorted by bin (ranked within a bin
    in index order here) and the (start, count) of each bin's run; then
    each bin adds its runs, tile after tile, onto the table's bin.
    Returns the table and, for every (row, element), the bucket its
    record carried, the bucket that the bin and the record's local
    bits it was summed from stand for, and how often it was summed."""
    r, c = table.shape
    n = vec.shape[0]
    out = table.clone()
    mask = (1 << plan.bin_bits) - 1
    carried = torch.full((r, n), -1, dtype=torch.int64)
    landed = torch.full((r, n), -1, dtype=torch.int64)
    times = torch.zeros((r, n), dtype=torch.int64)
    for begin in range(0, n, plan.chunk):
        tiles = []
        for t0 in range(begin, min(begin + plan.chunk, n), KI.TILE):
            idx = torch.arange(t0, min(t0 + KI.TILE, n))
            bk = T.hash_buckets(params, c, idx)
            runs, recs = [], []
            for j in range(r):
                order = torch.argsort(bk[j] >> plan.bin_bits, stable=True)
                cnt = torch.bincount(bk[j] >> plan.bin_bits,
                                     minlength=plan.nbins)
                runs.append(torch.stack([torch.cumsum(cnt, 0) - cnt, cnt]))
                recs.append((bk[j][order], idx[order]))
                carried[j, idx[order]] = bk[j][order]
            tiles.append((runs, recs))
        for j in range(r):
            for b in range(plan.nbins):
                for runs, recs in tiles:
                    start, count = (int(x) for x in runs[j][:, b])
                    bkt, el = (x[start:start + count] for x in recs[j])
                    at = (b << plan.bin_bits) | (bkt & mask)
                    landed[j, el] = at
                    times[j, el] += 1
                    out[j].index_add_(0, at, T.hash_signs(params, el)[j]
                                      * vec[el])
    return out, carried, landed, times


@pytest.mark.parametrize("r", [4, 5])
@pytest.mark.parametrize("c", [128, 2**12])
@pytest.mark.parametrize("n", [1000, 65_537])
@pytest.mark.parametrize("plan", ["wrapper", "narrow"])
def test_insert_decomposition_matches_oracle(r, c, n, plan):
    """The wrapper's plan, and a narrow one (bins of 512 counters, a
    chunk a tile) that puts a row in several bins and v in several
    chunks."""
    rng = np.random.default_rng(n + c + r)
    _, tp = _coeffs(r, n + r)
    vec = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    table = torch.from_numpy(rng.standard_normal((r, c)).astype(np.float32))
    p = KI.insert_plan(n, r, c)
    if plan == "narrow":
        bits = min(9, c.bit_length() - 3)
        p = KI.InsertPlan(rows=r, bin_bits=bits, nbins=c >> bits,
                          chunk=KI.TILE, chunks=-(-n // KI.TILE))
    got, carried, landed, times = _emulate_insert(table, tp, vec, p)
    want = KI.csvec_insert_ref(table, tp, vec)
    buckets = T.hash_buckets(tp, c, torch.arange(n))
    assert torch.equal(times, torch.ones_like(times))   # each once
    assert torch.equal(carried, buckets) and torch.equal(landed, buckets)
    torch.testing.assert_close(got, want, rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))


def _same(got, want) -> bool:
    """Equal values with NaN in the same places (``torch.equal`` holds a
    NaN unequal to itself)."""
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan],
                                                              want[~nan])


def _nonfinite_table(table, tp, n, plan, kind):
    """``table`` with a NaN in a bucket of the seed sample's (hash row 2),
    a NaN only in a bucket that no sample coordinate reaches and some
    other coordinate does, a whole NaN row as the int8 quantiser makes
    it from one NaN entry, or an inf in a sample bucket."""
    t = torch.from_numpy(table).clone()
    sample = torch.arange(plan.sample) * plan.stride
    bk = T.hash_buckets(tp, t.shape[1], sample)
    if kind == "nan_in_sample":
        t[2, bk[2, 0]] = float("nan")
    elif kind == "nan_outside":
        reached = T.hash_buckets(tp, t.shape[1], torch.arange(n))
        j, b = next((j, b) for j in range(t.shape[0])
                    for b in reached[j].unique().tolist()
                    if not bool((bk[j] == b).any()))
        t[j, b] = float("nan")
    elif kind == "nan_row":
        t[2, 17] = float("nan")
        t = T.dequantize_table(*T.quantize_table(t))
        assert bool(torch.isnan(t[2]).all())
    else:
        t[2, bk[2, 0]] = float("inf")
    return t


@pytest.mark.parametrize("r,kind,gshift", [
    (3, "normal", 0), (3, "ties", 0), (5, "normal", 0), (5, "ties", 0),
    (5, "normal", 3), (5, "ties", 3), (5, "flat", 3), (4, "normal", 0),
    (4, "ties", 0), (5, "nan_in_sample", 0), (5, "nan_outside", 3),
    (5, "nan_row", 0), (5, "inf", 3)])
def test_pruned_search_matches_the_streaming_top_k(r, kind, gshift):
    """The pruned search as the kernels take it (``emulate_pruned``: the
    sample's k-th best as tau0, fine and coarse masks, a refining sweep,
    the row test with its early exit, the exact top k of the survivors)
    equals ``topk_streaming`` on heavy-tailed and on integer tables whose
    k-th magnitude ties; gshift 3 puts 8 buckets under a coarse bit, as
    the train geometry puts 32. A flat table takes the unpruned sweep,
    and so does even r. So does a table that holds a NaN, in a sample
    bucket or only outside them or a whole row of them, where the result
    is the NaN estimates first, as ``topk_streaming`` and the reference's
    oracle rank them; an inf keeps the pruned path and stays exact."""
    n, k, c = 20_000, 64, 2**10
    table, p, tp = _table(r, c, n, seed=30 + r, ties=kind == "ties")
    if kind == "flat":
        table = np.full_like(table, 3.0)
    plan = KT.prune_plan(r, c, n, k)
    t = torch.from_numpy(table)
    if kind.startswith(("nan", "inf")):
        t = _nonfinite_table(table, tp, n, plan, kind)
    want = T.topk_streaming(T.CSVec(table=t, params=tp, dim=n), k)
    if r % 2 == 0:
        assert plan is None
        return
    assert plan == KT.PrunePlan(sample=n // 4, stride=4, refine=0,
                                gshift=0)
    # a refining sweep wider than the sample, as at the train geometry
    plan = dataclasses.replace(plan, refine=n // 2, gshift=gshift)
    (vals, idx), st = KT.emulate_pruned(t, tp, n, k, plan, chunk=4096)
    assert _same(vals, want[0]) and torch.equal(idx, want[1])
    if kind == "flat":
        assert st["dense"] and st["survivors"] == n
        return
    if kind.startswith("nan"):
        assert st["nonfinite"] and st["survivors"] == n
        assert bool(torch.isnan(vals).any())         # a NaN ranks first
        wv, wi = jax_topk_ref(jnp.asarray(t.numpy()), jnp.asarray(p), n, k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
        assert _same(vals, torch.from_numpy(np.array(wv)))
        return
    assert not st["nonfinite"]
    est = T.query_all(T.CSVec(table=t, params=tp, dim=n)).abs()
    kth = float(want[0][-1].abs())
    assert 0 < st["tau0"] <= st["tau"] <= kth      # drops no member
    # every coordinate at or above tau survives; the row test stops
    # before the last row for most coordinates, and looks up fine bits
    # (gshift > 0) only behind set coarse bits
    assert int((est >= st["tau"]).sum()) <= st["survivors"] < n
    assert st["coarse_tests"] < r * n
    assert (st["fine_tests"] > 0) == (gshift > 0)
    assert st["fine_tests"] < st["coarse_tests"]
    assert 0 < st["refine_survivors"] < n // 2
    if kind == "ties":                              # a tie at the k-th
        assert int((est == kth).sum()) > int((want[0].abs() == kth).sum())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("r,c,n,k", [(5, 128, 1000, 300), (4, 128, 1000, 7),
                                     (4, 2**12, 65_537, 64),
                                     (5, 2**16, 3_000_000, 512)])
def test_cuda_kernels_match_plain_versions(r, c, n, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(n)
    _, tp = _coeffs(r, n)
    vec = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    table = torch.zeros(r, c, device=dev)
    got = KI.csvec_insert(table, tp, vec)
    want = KI.csvec_insert_ref(table, tp, vec)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    for g, w in zip(KT.csvec_topk(want, tp, n, k),
                    KT.csvec_topk_ref(want, tp, n, k)):
        assert torch.equal(g, w)
    for g, w in zip(KQ.csvec_quant(want)[:3], KQ.csvec_quant_ref(want)[:3]):
        assert torch.equal(g, w)


# -- compression -------------------------------------------------------------


def test_compression_config_and_resolve_match_reference():
    for kw in (dict(mode="bad"), dict(wire_dtype="fp16"),
               dict(mode="countsketch", cs_cols=100),
               dict(mode="countsketch", cs_rows=0),
               dict(mode="countsketch", cs_target_ratio=1.0)):
        with pytest.raises(ValueError):
            JC.CompressionConfig(**kw)
        with pytest.raises(ValueError):
            TC.CompressionConfig(**kw)
    cfg = dict(mode="countsketch")
    for dim in (1_000_000, 1_100_048_384):
        assert TC.resolve_countsketch(TC.CompressionConfig(**cfg),
                                      dim).cs_cols == \
            JC.resolve_countsketch(JC.CompressionConfig(**cfg), dim).cs_cols
    assert TC.resolve_countsketch(TC.CompressionConfig(**cfg),
                                  1_100_048_384).cs_cols == 2**23
    for kw, dim in ((dict(cs_cols=2048), 5000),
                    (dict(cs_cols=128, cs_k=6000), 5000)):
        with pytest.raises(ValueError, match="invalid countsketch|exceeds"):
            TC.resolve_countsketch(TC.CompressionConfig(mode="countsketch",
                                                        **kw), dim,
                                   strict=True)
    with pytest.raises(ValueError, match="cannot auto-size"):
        TC.resolve_countsketch(TC.CompressionConfig(**cfg), 1000)
    for kw in (dict(mode="topk", int8=False), dict(mode="countsketch",
               cs_cols=1024, cs_p2=2, wire_dtype="int8"),
               dict(mode="countsketch", cs_cols=1024)):
        assert TC.compressed_bytes(50_000, TC.CompressionConfig(**kw)) == \
            JC.compressed_bytes(50_000, JC.CompressionConfig(**kw))
        assert TS.countsketch_wire_bytes(TC.CompressionConfig(**kw),
                                         50_000) == \
            JS.countsketch_wire_bytes(JC.CompressionConfig(**kw), 50_000)


def _grad_trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (30, 20), "b": {"c": (50,), "d": (7, 3, 11)}}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return (rng.standard_normal(s) * rng.pareto(3.0, s)).astype(
            np.float32)
    g = make(shapes)

    def conv(t, fn):
        return {k: conv(v, fn) if isinstance(v, dict) else fn(v)
                for k, v in t.items()}
    return conv(g, jnp.asarray), conv(g, torch.from_numpy)


def test_topk_compression_matches_reference():
    jg, tg = _grad_trees(3)
    for int8 in (True, False):
        jcfg = JC.CompressionConfig(mode="topk", topk_frac=0.1, int8=int8)
        tcfg = TC.CompressionConfig(mode="topk", topk_frac=0.1, int8=int8)
        jerr = JC.init_error_feedback(jg, jcfg)
        terr = TC.init_error_feedback(tg, tcfg)
        for _ in range(3):
            jc, jerr, js = JC.compress_grads(jg, jerr, jcfg)
            tc, terr, ts = TC.compress_grads(tg, terr, tcfg)
            assert ts == pytest.approx(js)
            for a, b in ((tc, jc), (terr, jerr)):
                np.testing.assert_array_equal(
                    a["b"]["d"].numpy(), np.asarray(b["b"]["d"]))
                np.testing.assert_array_equal(a["a"].numpy(),
                                              np.asarray(b["a"]))


@pytest.mark.parametrize("p2,wire", [(0, "fp32"), (2, "int8"), (3, "fp32")])
def test_countsketch_compression_matches_reference(p2, wire):
    """Three steps on one tree: the sent coordinates equal the
    reference's, u and v and the update agree, and v_new + update ==
    v_pre exactly away from the sent coordinates."""
    kw = dict(mode="countsketch", cs_rows=5, cs_cols=128, cs_k=40,
              cs_p2=p2, wire_dtype=wire)
    # the reference sweeps its top-k in chunks of 300 coordinates, the
    # port in one plain chunk (csvec.PLAIN_CHUNK): the result is the same
    jcfg = JC.CompressionConfig(cs_chunk=300, **kw)
    tcfg = TC.CompressionConfig(**kw)
    jg, tg = _grad_trees(11)
    dim = JS.flat_dim(jg)
    tp = csvec_params_from_jax(JS.grad_csvec(jcfg, dim).params)
    jerr = JC.init_error_feedback(jg, jcfg)
    terr = TC.init_error_feedback(tg, tcfg)
    for _ in range(3):
        v_pre = (terr["v"] + (terr["u"] * 0.9 + TS.FlatLayout(tg).ravel(tg)))
        jc, jerr, jst = JS.compress_grads_countsketch(jg, jerr, jcfg)
        tc, terr, tst = TS.compress_grads_countsketch(tg, terr, tcfg,
                                                      params=tp)
        assert tst == jst
        upd = TS.FlatLayout(tc).ravel(tc)
        sent = upd != 0
        from jax.flatten_util import ravel_pytree
        jupd = np.asarray(ravel_pytree(jc)[0])
        np.testing.assert_array_equal(sent.numpy(), jupd != 0)
        assert int(sent.sum()) == min(40, dim)
        np.testing.assert_allclose(upd.numpy(), jupd, rtol=1e-6, atol=1e-7)
        for key in ("u", "v"):
            np.testing.assert_allclose(terr[key].numpy(),
                                       np.asarray(jerr[key]),
                                       rtol=1e-6, atol=1e-7)
        assert bool((terr["u"][sent] == 0).all())
        assert torch.equal((terr["v"] + upd)[~sent], v_pre[~sent])
        torch.testing.assert_close((terr["v"] + upd)[sent], v_pre[sent],
                                   rtol=1e-6, atol=1e-6)


def test_data_parallel_axis_names_its_roadmap_item():
    """The data-parallel wire is ported: one call of the single-worker
    compressor refuses an axis and names the workers' path, whose finish
    over one worker is the single-worker result bit for bit."""
    _, tg = _grad_trees(0)
    cfg = TC.CompressionConfig(mode="countsketch", cs_cols=128, cs_p2=2)
    err = TC.init_error_feedback(tg, cfg)
    with pytest.raises(ValueError, match="countsketch_finish_dp"):
        TS.compress_grads_countsketch(tg, err, cfg, axis_name="data")
    want, want_state, _ = TS.compress_grads_countsketch(tg, err, cfg)
    local = TS.countsketch_local(tg, err, cfg)
    got, states, _ = TS.countsketch_finish_dp([local], local.cs, workers=1.0)
    from repro_torch.optim.flat import tree_leaves
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
    for k in ("u", "v"):
        assert torch.equal(states[0][k], want_state[k])
