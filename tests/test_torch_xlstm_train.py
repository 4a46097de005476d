"""xlstm training in the port against the JAX package, on the CPU.

The mLSTM gradient: ``mlstm_chunk_bwd_plain`` and ``mlstm_chunk_train``'s
backward against ``jax.vjp`` of the reference's ``_mlstm_chunk_scan``
from a zero state, and against torch.autograd through
``mlstm_chunk_plain``, at B 2, H 2, S 64, Dk 8, Dv 16 over chunks of 16
(four) and 64 (one), and with li strongly negative, where the
denominator's exp(-m) branch wins on some rows. Tolerance: each gradient
within 1e-5 * max|reference| (f32 on both sides, sums in other orders).

The model: reduced xlstm-1.3b at two layers a pattern position (16
layers, 14 mLSTM and 2 sLSTM, so the carry stacks' group-major order is
exercised), B 2 x S 16, monitor sketches at k_max 9, three train steps
with projections off, Gaussian and psparse, from the reference's
``init_train_state(PRNGKey(0))`` carried over by ``params_from_jax`` and
``tree_from_jax``. Losses within rtol 1e-5; parameters and the "res",
"mlstm_c" and "mlstm_n" triples within 1e-5 * max. One step at S 512
(two 256-token chunks) of the 8-layer reduced config is held at 1e-3 *
max, the reference's own chunk spread there (``tools/
xlstm_chunk_spread.py``, ``test_torch_mlstm.py``); at 16 layers the
reference's own spread reaches 4.8e-2 (see
``test_two_chunk_step_matches_reference``).

The carry update without the pad: the port contracts a carry's B rows
against the projections' first B token rows (psparse: the support rows
below B); the reference zero-pads the rows to the tree's binding. Held
at rtol 1e-5, atol 1e-6 * max for both projection kinds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.sketches import NodeSpec as JNodeSpec
from repro.sketches import init_node_tree as jax_init_node_tree
from repro.train.state import RunConfig as JRunConfig
from repro.train.state import init_train_state as jax_init_train_state
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import get_arch, reduced
from repro_torch.interop import params_from_jax, tree_from_jax
from repro_torch.kernels import mlstm_chunk as MC
from repro_torch.kernels.psparse_update import psparse_rows
from repro_torch.kernels.sketch_update import check_index_range, launch_plan
from repro_torch.launch import train as train_launcher
from repro_torch.models import transformer
from repro_torch.sketches import node_paths
from repro_torch.train.state import RunConfig, init_train_state
from repro_torch.train.step import make_train_step

TOL = 1e-5
SPREAD_TOL = 1e-3        # the reference's own chunk spread at S 512
B, S, K_MAX, STEPS = 2, 16, 9, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its steps are many small ops,
    on which a pool of a thread a core mostly spins (alone, the module's
    CPU time fell from 418 to 170 s with one), beside the other workers'
    tests. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(got, want, tol=TOL, rtol=TOL):
    want = np.asarray(want)
    atol = tol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the mLSTM gradient
# ---------------------------------------------------------------------------


def _chunk_inputs(seed, li_shift, Bq=2, H=2, Sq=64, Dk=8, Dv=16):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((Bq, H, Sq, Dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((Bq, H, Sq, Dv)).astype(np.float32)
    li = (rng.standard_normal((Bq, H, Sq)) * 0.5 + li_shift).astype(np.float32)
    x = rng.standard_normal((Bq, H, Sq)) + 2.0
    lf = (-np.log1p(np.exp(-x))).astype(np.float32)     # log_sigmoid
    dh = rng.standard_normal((Bq, H, Sq, Dv)).astype(np.float32)
    return (q, k, v, li, lf), dh


def _floor_rows(q, k, v, li, lf, chunk):
    """Rows whose denominator takes the exp(-m) branch of the max."""
    Bq, H, Sq, Dk = q.shape
    C0 = jnp.zeros((Bq, H, Dk, v.shape[-1]))
    n0, m0 = jnp.zeros((Bq, H, Dk)), jnp.zeros((Bq, H))
    ones = jnp.ones_like(jnp.asarray(v))
    # with v = 1, num = den and h = den / M: |h| is 1 on the |den| branch
    # and below 1 where the floor exp(-m) wins
    h1, _ = jssm._mlstm_chunk_scan(q, k, ones, li, lf, C0, n0, m0, chunk)
    return int(np.sum(np.abs(np.asarray(h1[..., 0])) < 1 - 1e-3))


@pytest.mark.parametrize("chunk,li_shift", [(16, 0.0), (64, 0.0),
                                            (16, -8.0)])
def test_mlstm_gradient_matches_jax_vjp(chunk, li_shift):
    ins, dh = _chunk_inputs(chunk + int(li_shift), li_shift)
    q, k, v, li, lf = ins
    Bq, H, Sq, Dk = q.shape

    def scan(q, k, v, li, lf):
        C0 = jnp.zeros((Bq, H, Dk, v.shape[-1]))
        return jssm._mlstm_chunk_scan(q, k, v, li, lf, C0,
                                      jnp.zeros((Bq, H, Dk)),
                                      jnp.zeros((Bq, H)), chunk)[0]

    _, vjp = jax.vjp(scan, *map(jnp.asarray, ins))
    want = vjp(jnp.asarray(dh))
    if li_shift < 0:
        assert _floor_rows(*ins, chunk) > 0
    t = [torch.from_numpy(a) for a in ins]
    tdh = torch.from_numpy(dh)
    h, _ = MC.mlstm_chunk_plain(*t, chunk=chunk)
    plain = MC.mlstm_chunk_bwd_plain(*t, h, tdh, chunk=chunk)
    leaves = [a.clone().requires_grad_(True) for a in t]
    ht, _ = MC.mlstm_chunk_train(*leaves, chunk=chunk)
    fn = torch.autograd.grad(ht, leaves, tdh)
    leaves = [a.clone().requires_grad_(True) for a in t]
    ha, _ = MC.mlstm_chunk_plain(*leaves, chunk=chunk)
    auto = torch.autograd.grad(ha, leaves, tdh)
    for w, p, f, a in zip(want, plain, fn, auto):
        for got in (p, f, a):
            _close(got, w, rtol=TOL)


def test_mlstm_bwd_flops_counts_the_train_shape():
    """The bound's operation count at xlstm's train shape: 50.5 GFLOP
    (0.75 ms on an H100's 67 TFLOP/s FMA units)."""
    flops = MC.mlstm_bwd_flops(4, 4, 512, 512, 1024, 256)
    assert flops == 32 * (256 * 257 * (3 * 512 + 2 * 1024)
                          + 10 * 256 * 512 * 1024)
    assert round(flops / 1e9, 1) == 50.5


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _cfgs(layers_per_pattern=2):
    return (jax_reduced(jax_get_arch("xlstm-1.3b"),
                        layers_per_pattern=layers_per_pattern),
            reduced(get_arch("xlstm-1.3b"),
                    layers_per_pattern=layers_per_pattern))


def _runs(proj, seq_len=S):
    kw = dict(enabled=proj != "off", k_max=K_MAX, beta=0.9,
              recon_mode="fast",
              proj_kind=proj if proj != "off" else "gaussian")
    common = dict(seq_len=seq_len, global_batch=B, warmup_steps=2,
                  total_steps=40)
    return (JRunConfig(**common, sketch=jtransformer.SketchSettings(**kw)),
            RunConfig(**common, sketch=transformer.SketchSettings(**kw)))


def _states(proj, seq_len=S, layers_per_pattern=2):
    jcfg, cfg = _cfgs(layers_per_pattern)
    jrun, run = _runs(proj, seq_len)
    js = jax_init_train_state(jax.random.PRNGKey(0), jcfg, jrun)
    tree = (tree_from_jax(jax.tree.map(np.asarray, js.sketch))
            if js.sketch is not None else None)
    ts = init_train_state(0, cfg, run, device="cpu", sketch=tree,
                          params=params_from_jax(
                              jax.tree.map(np.asarray, js.params)))
    return (jcfg, jrun, js), (cfg, run, ts)


def _batches(n, vocab, seq_len=S):
    rng = np.random.default_rng(7)
    for _ in range(n):
        tok = rng.integers(0, vocab, (B, seq_len + 1))
        yield ({"tokens": jnp.asarray(tok[:, :-1]),
                "labels": jnp.asarray(tok[:, 1:])},
               {"tokens": torch.from_numpy(tok[:, :-1]),
                "labels": torch.from_numpy(tok[:, 1:])})


def _hold_states(js, ts, tol):
    want = params_from_jax(jax.tree.map(np.asarray, js.params))
    flat_w = [(p, t) for p, t in _leaves(want)]
    flat_g = dict(_leaves(ts.params))
    for path, w in flat_w:
        _close(flat_g[path], _np(w), tol=tol, rtol=tol)
    if js.sketch is None:
        assert ts.sketch is None
        return
    assert sorted(ts.sketch.nodes) == sorted(js.sketch.nodes)
    for name, node in js.sketch.nodes.items():
        for a in "xyz":
            _close(getattr(ts.sketch.nodes[name], a), getattr(node, a),
                   tol=tol, rtol=tol)
    assert ts.sketch.step == int(js.sketch.step)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("proj", ["off", "gaussian", "psparse"])
def test_train_steps_match_reference(proj):
    (jcfg, jrun, js), (cfg, run, ts) = _states(proj)
    jstep = jax.jit(jax_make_train_step(jcfg, jrun))
    step = make_train_step(cfg, run)
    for jb, tb in _batches(STEPS, cfg.vocab_size):
        js, jm = jstep(js, jb)
        ts, tm = step(ts, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=TOL)
        # AdamW's step barely depends on the gradient's scale: its norm
        # is held on its own
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=TOL)
        assert tm["skipped_total"] == 0
    _hold_states(js, ts, TOL)
    if proj != "off":
        # one monitor row per stack entry: 16 "res", 14 of each carry node
        assert ts.monitor.buffer.shape[1] == len(node_paths(ts.sketch)) == 44
        np.testing.assert_allclose(
            _np(ts.monitor.buffer), np.asarray(js.monitor.buffer),
            rtol=1e-4, atol=1e-4 * float(np.abs(js.monitor.buffer).max()))


def test_two_chunk_step_matches_reference():
    """S 512: the mLSTM state and its gradient cross a chunk. At the
    8-layer reduced config, where the reference's own chunk spread was
    measured: with only its mLSTM chunk moved from 256 to 64, the
    reference's step moves its "res" triples by 3.6e-4 of max at 8
    layers, but by 4.8e-2 at 16 (the random reduced model amplifies
    rounding layer by layer), so 1e-3 holds only at 8."""
    (jcfg, jrun, js), (cfg, run, ts) = _states("gaussian", seq_len=512,
                                                layers_per_pattern=1)
    (jb, tb), = _batches(1, cfg.vocab_size, seq_len=512)
    js, jm = jax.jit(jax_make_train_step(jcfg, jrun))(js, jb)
    ts, tm = make_train_step(cfg, run)(ts, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=SPREAD_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=SPREAD_TOL)
    _hold_states(js, ts, SPREAD_TOL)


@pytest.mark.parametrize("seq_len", [64, 128, 256])
def test_grad_norm_matches_reference_as_it_grows_with_length(seq_len):
    """The gradient's global norm, one step of the 8-layer reduced config
    (sketches off: they only observe): 27.3 at S 64, 68.6 at 128, 121 at
    256 and 536 at 512 in the reference, so its growth with the sequence
    is the reference's arithmetic. Held at SPREAD_TOL: the reference's
    own norm moves by 1.1e-5, 4.0e-5, 2.7e-4 and 7.9e-4 at these lengths
    when only its mLSTM chunk moves from 256 to 64 or 16; the port read
    2.1e-5, 8.0e-6, 9.2e-4 and 6.6e-4."""
    (jcfg, jrun, js), (cfg, run, ts) = _states("off", seq_len=seq_len,
                                                layers_per_pattern=1)
    (jb, tb), = _batches(1, cfg.vocab_size, seq_len=seq_len)
    js, jm = jax.jit(jax_make_train_step(jcfg, jrun))(js, jb)
    ts, tm = make_train_step(cfg, run)(ts, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=SPREAD_TOL)


def test_node_groups_and_stacks_match_reference():
    jcfg, cfg = _cfgs()
    assert transformer.sketch_groups(cfg) == jtransformer.sketch_groups(jcfg)
    assert {g: s.layers for g, s in
            transformer.transformer_node_specs(cfg).items()} == \
        {g: s.layers for g, s in
         jtransformer.transformer_node_specs(jcfg).items()}
    for name in ("res", "mlstm_c"):
        # the reference's stack order: G x its pattern positions, then
        # the tail's
        pos = jtransformer.node_positions(name, jcfg.pattern)
        want = [g * len(jcfg.pattern) + i for g in range(jcfg.num_groups)
                for i in pos]
        assert transformer.node_layers(name, cfg) == want
    full = get_arch("xlstm-1.3b")
    assert transformer.node_layer_count(full, "mlstm_c") == 42
    assert transformer.sketch_groups(full)["mlstm_c"] == 2_097_152


@pytest.mark.parametrize("proj_kind", ["gaussian", "psparse"])
def test_carry_update_matches_padded_reference(proj_kind):
    T, rows, w, k = 16, 4, 24, 5
    st_kw = dict(enabled=True, k_max=k, beta=0.9, proj_kind=proj_kind,
                 proj_density=0.5)
    jst = jtransformer.SketchSettings(**st_kw)
    st = transformer.SketchSettings(**st_kw)
    jtree = jax_init_node_tree(jax.random.PRNGKey(3),
                               {"mlstm_c": JNodeSpec(width=w, layers=1)}, T,
                               k, proj_kind=proj_kind, proj_density=0.5)
    rng = np.random.default_rng(3)
    node = jax.tree.map(lambda t: t[0], jtree.nodes["mlstm_c"])
    node = dataclasses.replace(node, **{
        a: jnp.asarray(rng.standard_normal((w, k)).astype(np.float32))
        for a in "xyz"})
    a = rng.standard_normal((rows, w)).astype(np.float32)
    k_active = jnp.asarray(3)
    want = jtransformer._update_carry_triple(node, jnp.asarray(a),
                                              jtree.proj, k_active, jst)
    tree = tree_from_jax(jax.tree.map(np.asarray, jtree))
    if proj_kind == "psparse":
        # the check means something only where support rows fall below B
        assert all(bool((psparse_rows(p, tree.proj.m, T) < rows).any())
                   for p in tree.proj.params)
    from repro_torch.sketches import SketchNode
    tnode = SketchNode(*(torch.from_numpy(np.asarray(getattr(node, f)))
                         for f in ("x", "y", "z", "psi")))
    got = transformer._update_carry_triple(
        tnode, torch.from_numpy(a), tree.proj, torch.tensor(3), st)
    for f in "xyz":
        _close(getattr(got, f), getattr(want, f), tol=1e-6)
    with pytest.raises(ValueError, match="num_tokens"):
        transformer._update_carry_triple(tnode, torch.zeros((T + 1, w)),
                                         tree.proj, torch.tensor(3), st)


def test_carry_update_plan_at_full_width():
    """mlstm_c's update on the card: T = B = 4 rows of d 2,097,152 at
    k 9 take the FMA kernel with one split, inside its 32-bit indices."""
    splits, per = launch_plan(4, 2_097_152, 132, False)
    assert (splits, per) == (1, 32)
    check_index_range(2_097_152, 9, splits)
    with pytest.raises(ValueError, match="32-bit"):
        check_index_range(2_097_152, 9, 38)


def test_carry_live_slots_are_the_support_rows_below_b():
    """psparse at mlstm_c's full width: of the 3m = 615 slots bound to the
    tree's 2,048 token rows, the kernel sums only those whose row falls
    below the carry's B 4 (``live_slots``), in one split, and the plain
    version of those rows alone equals the update of the rows padded to
    2,048 with zeros."""
    from repro_torch.kernels import psparse_update as P
    T, rows, k = 2048, 4, 9
    m = P.psparse_dim(T, k, 0.1)
    gen = torch.Generator().manual_seed(11)
    params = P.psparse_hash_params(gen)
    while not all(bool((P.psparse_rows(p, m, T) < rows).any())
                  for p in params):
        params = P.psparse_hash_params(gen)
    slots = P.live_slots(params, m, T, rows, "cpu")
    want = [mat * m + u for mat, p in enumerate(params) for u in range(m)
            if int(P.psparse_rows(p, m, T)[u]) < rows]
    assert slots.dtype == torch.int32 and slots.tolist() == want
    assert 3 <= len(want) < 3 * m
    assert launch_plan(max(len(want), 1), 2_097_152, 132, False) == (1, 32)
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.standard_normal((rows, 40)).astype(np.float32))
    xyz = [torch.from_numpy(rng.standard_normal((40, k)).astype(np.float32))
           for _ in range(3)]
    psi = torch.from_numpy(rng.random(k).astype(np.float32))
    got = P.psparse_update_ref(a, *xyz, params, psi, beta=0.9, m=m,
                               num_tokens=T)
    padded = torch.cat([a, torch.zeros((T - rows, 40))])
    full = P.psparse_update_ref(padded, *xyz, params, psi, beta=0.9, m=m)
    for g, w in zip(got, full):
        _close(g, w, tol=1e-6)


def test_launcher_trains_and_resumes_reduced_xlstm(tmp_path):
    argv = ["--arch", "xlstm-1.3b", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq-len", "16", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path)]
    state, hist = train_launcher.main(argv + ["--steps", "2"])
    assert len(hist) == 2 and state.skipped == 0
    assert all(np.isfinite(h["loss"]) for h in hist)
    state, hist = train_launcher.main(argv + ["--steps", "4"])
    assert state.step == 4 and len(hist) == 2      # resumed at step 2
