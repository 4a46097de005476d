"""The port's W = 4 data-parallel LM step against the reference's
``make_dp_train_step``, on the CPU, at the reduced tinyllama-1.1b (2
layers, d 64, d_ff 128; f32), global batch 8 x S 16, sketched backprop at
k_max 9, beta 0.9.

The reference runs under shard_map over 4 forced host devices in ONE
subprocess for this module (the test process keeps one device), as
``tests/test_distributed.py`` runs its DP tests: for each layout it
draws the state from PRNGKey(0), takes 3 steps on batches from
PRNGKey(0) folded with the step, and writes the initial state, the
count sketch's hash coefficients, the batches, every step's metrics and
selections, the final state (its per-worker ``err`` and ``sketch_err``
gathered per worker) and its collective trace and plan into one .npz.
The port starts from those numbers (``repro_torch.interop``) and takes
the same steps with its W workers in one process.

Each of the port's steps starts from the reference's state before it
(weights, tree, moments and every worker's ledgers carried over), so a
step's differences do not compound. Tolerances (f32 on both sides, sums
in other orders; the per-worker increments and gradients come from the
port's own kernels' plain versions): losses rtol 1e-5; AdamW moments
within 1e-6 of their max; parameters within 1e-6 of their max plus the
first moment's tolerance carried through the AdamW step (lr m_hat /
(sqrt(v_hat) + eps) multiplies it by up to lr / eps at a coordinate
whose gradient is ~1e-9 of the largest); sketch trees rtol 1e-5, atol
1e-6 of max; each worker's {u, v} within 1e-6 of max; every count-sketch
selection equal. On the int8 sketch wire the increments' rounding in
another order can move an int8 code by one step, so there (as
``_check_int8_tree`` says) the tree plus the workers' ledgers is held,
the moved codes counted, and the ledgers held within 1e-6 of the merged
increments' max, the values the wire quantised.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import types

import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.train.state import ConfigError as JConfigError
from repro.train.state import RunConfig as JRunConfig
from repro.models.transformer import SketchSettings as JSketchSettings
from repro_torch import interop
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_arch, reduced
from repro_torch.models.transformer import SketchSettings, forward
from repro_torch.optim import sketched_sgd as TS
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compression import CompressionConfig
from repro_torch.optim.flat import FlatLayout
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.parallel.collectives import collective_trace
from repro_torch.train import loop as loop_mod
from repro_torch.train.state import ConfigError, RunConfig, init_train_state
from repro_torch.train.step import collective_plan, make_dp_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, B, S, K_MAX, STEPS = 4, 8, 16, 9, 3
CS = dict(mode="countsketch", cs_rows=5, cs_cols=512, cs_k=64,
          cs_momentum=0.0)
# name -> (RunConfig keywords, count-sketch keywords or None)
LAYOUTS = {
    "per_node": (dict(dp_collective="per_node"), None),
    "fused_ring_cs_p2o": (dict(dp_collective="fused", ring_wire=True,
                               p2_overlap=True), dict(CS, cs_p2=2)),
    "fused_int8": (dict(dp_collective="fused", sketch_wire_dtype="int8"),
                   None),
    "fused_int8_ring": (dict(dp_collective="fused", sketch_wire_dtype="int8",
                             ring_wire=True), None),
    "overlap_int8_ring_cs": (dict(dp_collective="overlap",
                                  sketch_wire_dtype="int8", ring_wire=True),
                             dict(CS, cs_p2=2)),
}
RUN_KW = dict(seq_len=S, global_batch=B, dp_axis_name="data", dp_workers=W,
              warmup_steps=2, total_steps=10)

REF_CODE = """
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.checkpoint.checkpointer import gather_per_worker
    from repro.configs import get_arch, reduced
    from repro.data.synthetic import lm_batch
    from repro.models.transformer import SketchSettings
    from repro.optim import sketched_sgd as JS
    from repro.optim.adamw import AdamWConfig
    from repro.optim.compression import CompressionConfig
    from repro.parallel.collectives import collective_trace
    from repro.train.state import RunConfig, init_train_state
    from repro.train.step import collective_plan, make_dp_train_step

    LAYOUTS, RUN_KW, W, STEPS, K_MAX = json.loads(sys.argv[2])
    mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
    cfg = reduced(get_arch("tinyllama-1.1b"))
    key = jax.random.PRNGKey(0)
    out = {}
    sel = []
    orig_cc, orig_rc = JS.countsketch_complete, JS._recover_candidates

    def cc(*a, **kw):
        res = orig_cc(*a, **kw)
        jax.debug.callback(lambda i: sel.append(np.asarray(i)), res[1])
        return res

    JS.countsketch_complete = cc

    def put(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)

    for name, (kw, ckw) in LAYOUTS.items():
        run = RunConfig(
            **RUN_KW, **kw, optimizer=AdamWConfig(lr=1e-3),
            sketch=SketchSettings(enabled=True, k_max=K_MAX, beta=0.9),
            compression=CompressionConfig(**ckw) if ckw else None)
        state = init_train_state(key, cfg, run)
        put(name + "/proj", state.sketch.proj)
        put(name + "/psi", {n: v.psi for n, v in state.sketch.nodes.items()})
        out[name + "/rank"] = np.asarray(state.sketch.rank)
        if ckw:
            out[name + "/cs_params"] = np.asarray(JS.grad_csvec(
                run.compression, JS.flat_dim(state.params)).params)
        state = jax.device_put(state, NamedSharding(mesh, P()))
        step = jax.jit(make_dp_train_step(cfg, run, mesh))

        def dump(s):
            pre = f"{name}/state{s}/"
            put(pre + "params", state.params)
            put(pre + "opt", {k: v for k, v in state.opt.items()
                              if k not in ("err", "sketch_err")})
            put(pre + "nodes", {n: (v.x, v.y, v.z)
                                for n, v in state.sketch.nodes.items()})
            for k in ("err", "sketch_err"):
                if k in state.opt:
                    put(pre + k, gather_per_worker(state.opt[k], mesh,
                                                   "data"))

        dump(0)
        with collective_trace() as log:
            step.lower(state, {"tokens": jnp.zeros((8, 16), jnp.int32),
                               "labels": jnp.zeros((8, 16), jnp.int32)})
        out[name + "/trace"] = np.asarray(json.dumps(log))
        out[name + "/plan"] = np.asarray(json.dumps(
            collective_plan(cfg, run)))
        for s in range(STEPS):
            tok, lab = lm_batch(jax.random.fold_in(key, s), 8, 16,
                                cfg.vocab_size)
            out[f"{name}/batch{s}/tokens"] = np.asarray(tok)
            out[f"{name}/batch{s}/labels"] = np.asarray(lab)
            sel.clear()
            state, m = step(state, {"tokens": tok, "labels": lab})
            jax.block_until_ready(state)
            jax.effects_barrier()
            for k in ("loss", "grad_norm"):
                out[f"{name}/step{s}/{k}"] = np.asarray(m[k])
            if sel:
                assert len(sel) == W and all(
                    np.array_equal(sel[0], x) for x in sel), len(sel)
                out[f"{name}/step{s}/sel"] = sel[0]
            dump(s + 1)
        print(name, "done", flush=True)
    np.savez(sys.argv[1], **out)
    print("OK")
"""


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@pytest.fixture(scope="module")
def ref():
    """The reference's runs of every layout, from one subprocess."""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ref.npz")
        proc = subprocess.run(
            [sys.executable, "-c", textwrap.dedent(REF_CODE), path,
             json.dumps([LAYOUTS, RUN_KW, W, STEPS, K_MAX])],
            capture_output=True, text=True, env=env, timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        with np.load(path) as z:
            return {k: z[k] for k in z.files}


def _sub(ref, prefix):
    """The entries under ``prefix``, keyed by the rest of their path."""
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


def _tree(flat: dict):
    """A nested dict/list tree from ``jax.tree_util.keystr`` paths."""
    import re
    root: dict = {}
    for path, leaf in flat.items():
        head = path.split("[", 1)[0]
        keys = [head] + [int(k) if k.isdigit() else k
                         for k in re.findall(r"\['?([^'\]]+)'?\]", path)]
        node = root
        for a in keys[:-1]:
            node = node.setdefault(a, {})
        node[keys[-1]] = leaf

    def lists(t):
        if isinstance(t, dict):
            t = {k: lists(v) for k, v in t.items()}
            if t and all(isinstance(k, int) for k in t):
                return [t[i] for i in sorted(t)]
        return t
    return lists(root)


def _params(tree: dict) -> dict:
    """A reference parameter (or moment) tree from ``_tree``, whose empty
    "tail" list had no leaf to record it."""
    return interop.params_from_jax(dict({"tail": []}, **tree))


def _port_run(name):
    kw, ckw = LAYOUTS[name]
    return RunConfig(**RUN_KW, **kw, optimizer=AdamWConfig(lr=1e-3),
                     sketch=SketchSettings(enabled=True, k_max=K_MAX,
                                           beta=0.9),
                     compression=CompressionConfig(**ckw) if ckw else None)


def _port_state(ref, name, s, cfg, run):
    """The port's state from the reference's after ``s`` steps: weights,
    tree, AdamW moments and each worker's ledgers."""
    st = _tree(_sub(ref, f"{name}/state{s}/"))
    psi = _tree(_sub(ref, name + "/psi"))[""]
    nodes = {n: types.SimpleNamespace(x=v[0], y=v[1], z=v[2], psi=psi[n])
             for n, v in st["nodes"].items()}
    jtree = types.SimpleNamespace(
        nodes=nodes, proj=_tree(_sub(ref, name + "/proj"))[""],
        rank=ref[name + "/rank"], step=s, epoch=0)
    state = init_train_state(0, cfg, run, device="cpu",
                             params=_params(st["params"]),
                             sketch=interop.tree_from_jax(jtree))
    opt = {"m": _params(st["opt"]["m"]), "v": _params(st["opt"]["v"]),
           "count": torch.from_numpy(st["opt"]["count"]).int()}
    if "err" in st:
        opt["err"] = interop.error_feedback_from_jax(st["err"])
    if "sketch_err" in st:
        opt["sketch_err"] = interop.sketch_err_from_jax(st["sketch_err"])
    return dataclasses.replace(state, opt=opt, step=s)


def _batch(ref, name, s):
    return {k: torch.from_numpy(ref[f"{name}/batch{s}/{k}"]).long()
            for k in ("tokens", "labels")}


@pytest.fixture(scope="module")
def port(ref):
    """Each of the port's steps from the reference's state before it,
    with every count-sketch selection and each step's collective
    trace."""
    cfg = reduced(get_arch("tinyllama-1.1b"))
    out = {}
    for name in LAYOUTS:
        run = _port_run(name)
        cs_params = None
        if name + "/cs_params" in ref:
            cs_params = interop.csvec_params_from_jax(ref[name + "/cs_params"])
        step = make_dp_train_step(cfg, run, cs_params=cs_params)
        sels, metrics, traces, states = [], [], [], []
        orig = TS._select

        def record(*a, **kw):
            res = orig(*a, **kw)
            sels.append(res[0].numpy())
            return res

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TS, "_select", record)
            for s in range(STEPS):
                with collective_trace() as log:
                    state, m = step(_port_state(ref, name, s, cfg, run),
                                    _batch(ref, name, s))
                metrics.append(m)
                traces.append(log)
                states.append(state)
        out[name] = dict(states=states, metrics=metrics, sels=sels,
                         traces=traces, run=run)
    return out


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _of_max(a, frac):
    return frac * float(np.abs(np.asarray(a)).max())


def _check_int8_tree(state, want, before, beta, what):
    """The int8 sketch wire's tree and ledgers after one step. A code
    moves by one step where the increments, summed in another order than
    the reference's, lie within an ulp of a rounding boundary: the tree
    and that worker's ledger then differ by the row's scale in opposite
    directions. So: the mass-conserved sum tree + sum_w ledger_w within
    the tree's tolerance everywhere; the tree within it but at the moved
    codes (at most 1 in 1000 elements); every ledger within 1e-6 of the
    merged increments' max (the values the wire quantised) but there."""
    for n, (x, y, z) in want["nodes"].items():
        for i, a in enumerate("xyz"):
            tree_w, led_w = (x, y, z)[i], want["sketch_err"][n][a]
            tree_p = _np(getattr(state.sketch.nodes[n], a))
            led_p = _np(state.opt["sketch_err"][n][a])
            tol = 1e-5 * np.abs(tree_w) + _of_max(tree_w, 1e-6)
            _close(tree_p + led_p.sum(0), tree_w + led_w.sum(0), 1e-5,
                   _of_max(tree_w, 1e-6), f"{what} {n}.{a} tree + ledgers")
            moved = np.abs(tree_p - tree_w) > tol
            assert moved.sum() <= max(1, moved.size // 1000), \
                (what, n, a, int(moved.sum()))
            merged = tree_w - beta * before["nodes"][n][i]
            keep = ~np.broadcast_to(moved, led_p.shape)
            _close(led_p[keep], led_w[keep], 0, _of_max(merged, 1e-6),
                   f"{what} sketch_err {n}.{a}")


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_dp_step_matches_reference(ref, port, name):
    pr = port[name]
    int8 = pr["run"].sketch_wire_dtype == "int8"
    for s in range(STEPS):
        what = f"{name} step {s}"
        m, state = pr["metrics"][s], pr["states"][s]
        np.testing.assert_allclose(float(m["loss"]),
                                   float(ref[f"{name}/step{s}/loss"]),
                                   rtol=1e-5)
        assert m["skipped_total"] == 0
        want = _tree(_sub(ref, f"{name}/state{s + 1}/"))
        before = _tree(_sub(ref, f"{name}/state{s}/"))
        wp = _params(want["params"])
        lay = FlatLayout(wp)
        mom = {k: lay.ravel(_params(want["opt"][k])).numpy()
               for k in ("m", "v")}
        for k, wk in mom.items():
            _close(lay.ravel(state.opt[k]), wk, 0, _of_max(wk, 1e-6),
                   f"{what} {k}")
        # the parameters' tolerance: 1e-6 of their max, plus the first
        # moment's carried through the step lr * m_hat / (sqrt(v_hat) +
        # eps), which at a coordinate whose gradient is ~1e-9 (v_hat
        # below eps^2) multiplies it by lr / eps
        lr = 1e-3 * warmup_cosine(s, warmup_steps=2, total_steps=10)
        b1c, b2c = 1 - 0.9 ** (s + 1), 1 - 0.95 ** (s + 1)
        carried = lr * _of_max(mom["m"], 1e-6) / (
            b1c * (np.sqrt(mom["v"] / b2c) + 1e-8))
        diff = np.abs(lay.ravel(state.params).numpy()
                      - lay.ravel(wp).numpy())
        bad = diff > _of_max(lay.ravel(wp), 1e-6) + carried
        assert not bad.any(), (what, "params", np.flatnonzero(bad)[:5],
                               diff[bad][:5])
        assert int(state.opt["count"]) == s + 1
        assert state.sketch.step == s + 1
        if int8:
            _check_int8_tree(state, want, before, 0.9, what)
        else:
            for n, leaves in want["nodes"].items():
                for a, w in zip("xyz", leaves):
                    _close(getattr(state.sketch.nodes[n], a), w, 1e-5,
                           _of_max(w, 1e-6), f"{what} tree {n}.{a}")
        if "err" in want:
            for k in ("u", "v"):
                w = want["err"][k]
                assert w.shape[0] == W
                _close(state.opt["err"][k], w, 0, _of_max(w, 1e-6),
                       f"{what} err {k}")


@pytest.mark.parametrize("name", [n for n, (_, c) in LAYOUTS.items() if c])
def test_dp_countsketch_selects_the_reference_coordinates(ref, port, name):
    pr = port[name]
    assert len(pr["sels"]) == STEPS
    for s, got in enumerate(pr["sels"]):
        np.testing.assert_array_equal(got, ref[f"{name}/step{s}/sel"])


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_collective_trace_matches_the_references(ref, port, name):
    """The collectives the port records: the reference's own trace where
    it records them all (the flat-segment layouts), and the count and
    bytes of the reference's ``collective_plan`` where that accounts
    every collective (per_node records its node psums, which the
    reference's forward issues unrecorded)."""
    cfg = reduced(get_arch("tinyllama-1.1b"))
    plan = json.loads(str(ref[name + "/plan"]))
    trace = json.loads(str(ref[name + "/trace"]))
    for log in port[name]["traces"]:
        if name == "per_node":
            assert len(log) == plan["collectives"]
            assert sum(r["bytes"] for r in log) == plan["wire_bytes"]
        else:
            assert log == trace
    mine = collective_plan(cfg, port[name]["run"])
    for k in ("layout", "collectives", "wire_bytes", "by_kind", "ring_wire",
              "sketch_wire_dtype", "p2_overlap"):
        assert mine[k] == plan[k], k


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-34b",
                                  "gemma3-27b", "xlstm-1.3b",
                                  "recurrentgemma-2b", "musicgen-large",
                                  "internvl2-76b"])
def test_per_node_plan_counts_the_references_leaves(arch):
    """per_node's collective count at full width (one mean a parameter
    leaf of the reference's stacked tree) equals the reference's plan,
    which counts ``abstract_params``' leaves; the port counts them from
    the config, as built on a reduced config, and with ``num_params``
    given takes one leaf, as the reference does."""
    from repro.train.step import collective_plan as jax_plan
    from repro_torch.models import transformer as T

    kw = dict(seq_len=S, global_batch=B, dp_axis_name="data", dp_workers=W,
              dp_collective="per_node")
    sk = dict(enabled=False)
    want = jax_plan(jax_get_arch(arch), JRunConfig(
        **kw, sketch=JSketchSettings(**sk)))
    got = collective_plan(get_arch(arch), RunConfig(
        **kw, sketch=SketchSettings(**sk)))
    assert (got["collectives"], got["wire_bytes"]) == (
        want["collectives"], want["wire_bytes"])
    small = reduced(get_arch(arch))
    assert T.num_reference_leaves(small) == len(T.reference_leaves(
        T.init_params(torch.Generator().manual_seed(0), small), small))
    given = collective_plan(get_arch(arch), RunConfig(
        **kw, sketch=SketchSettings(**sk)), num_params=1000)
    assert given["collectives"] == jax_plan(jax_get_arch(arch), JRunConfig(
        **kw, sketch=JSketchSettings(**sk)), num_params=1000)["collectives"]


def test_dp_exact_sketch_is_the_sum_of_the_shard_increments():
    """The W = 4 per-node step's tree from zero sketches is the sum of the
    four shards' single-worker forward increments, as
    ``test_dp_exact_sketch_matches_full_batch_w4`` holds the reference."""
    cfg = reduced(get_arch("tinyllama-1.1b"))
    run = RunConfig(**RUN_KW, dp_collective="per_node",
                    sketch=SketchSettings(enabled=True, k_max=K_MAX,
                                          beta=0.9))
    state = init_train_state(1, cfg, run, device="cpu")
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    new, m = make_dp_train_step(cfg, run)(state, {"tokens": tokens,
                                                  "labels": tokens})
    want = None
    for w in range(W):
        out = forward(state.params, tokens[2 * w:2 * w + 2], cfg=cfg,
                      mode="train", sketch_state=state.sketch,
                      settings=run.sketch)
        inc = [getattr(n, a) for n in out["sketch_state"].nodes.values()
               for a in "xyz"]
        want = inc if want is None else [a + b for a, b in zip(want, inc)]
    got = [getattr(n, a) for n in new.sketch.nodes.values() for a in "xyz"]
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=5e-6, atol=5e-6)
    assert np.isfinite(float(m["loss"]))


FLAG_GRID = [
    dict(),
    dict(dp_axis_name="data", dp_workers=4),
    dict(dp_axis_name="data", dp_workers=3),
    dict(dp_workers=0),
    dict(dp_collective="ring"),
    dict(dp_merge="allgather"),
    dict(sketch_wire_dtype="fp16"),
    dict(sketch_wire_dtype="int8"),
    dict(dp_axis_name="data", dp_workers=4, sketch_wire_dtype="int8",
         dp_collective="per_node"),
    dict(dp_axis_name="data", dp_workers=4, sketch_wire_dtype="int8"),
    dict(ring_wire=True),
    dict(dp_axis_name="data", dp_workers=4, ring_wire=True,
         dp_collective="per_node"),
    dict(dp_axis_name="data", dp_workers=4, ring_wire=True),
    dict(dp_axis_name="data", dp_workers=4, ring_wire=True,
         sketch_wire_dtype="int8", dp_collective="overlap"),
    dict(dp_merge="reduce_scatter", sketch_enabled=True),
    dict(dp_axis_name="data", dp_workers=4, dp_merge="reduce_scatter",
         dp_collective="per_node"),
    dict(dp_axis_name="data", dp_workers=4, dp_merge="reduce_scatter",
         sketch_wire_dtype="int8"),
    dict(dp_axis_name="data", dp_workers=4, dp_merge="reduce_scatter",
         ring_wire=True),
    dict(dp_axis_name=("pod", "data"), dp_workers=4, ring_wire=True),
    dict(dp_axis_name=("pod", "data"), dp_workers=4),
    dict(dp_axis_name="data", dp_workers=4, dp_merge="reduce_scatter",
         dp_collective="overlap"),
    dict(sketch_dp_defer=True),
    dict(dp_axis_name="data", dp_workers=4, sketch_dp_defer=True,
         dp_collective="per_node"),
    dict(dp_axis_name="data", dp_workers=4, sketch_dp_premerged=True),
    dict(dp_axis_name="data", dp_workers=4, sketch_dp_defer=True),
]


def _build(run_cls, sk_cls, kw):
    kw = dict(kw)
    sk = dict(enabled=kw.pop("sketch_enabled", True))
    for k in ("dp_defer", "dp_premerged"):
        if kw.pop("sketch_" + k, False):
            sk[k] = True
    return run_cls(seq_len=S, global_batch=B, sketch=sk_cls(**sk), **kw)


def _outcome(run_cls, sk_cls, err_cls, kw):
    try:
        _build(run_cls, sk_cls, kw)
    except err_cls as e:
        return ("ConfigError", e.fields)
    except NotImplementedError as e:
        return ("NotImplementedError", "A14" in str(e))
    return ("ok", None)


@pytest.mark.parametrize("kw", FLAG_GRID, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()) or "default")
def test_run_config_matrix_names_the_references_fields(kw):
    want = _outcome(JRunConfig, JSketchSettings, JConfigError, kw)
    got = _outcome(RunConfig, SketchSettings, ConfigError, kw)
    if want[0] == "ok" and (kw.get("dp_merge") == "reduce_scatter" or
                            isinstance(kw.get("dp_axis_name"), tuple)):
        assert got == ("NotImplementedError", True), got
    else:
        assert got == want


def test_per_worker_checkpoint_round_trip_and_elastic_split(tmp_path):
    """The stacked per-worker {u, v} and sketch_err ("per_worker_v1")
    survive a save and restore bit for bit at W = 4, and a restore at
    W = 2 gives each worker total / 2 of every residual."""
    cfg = reduced(get_arch("tinyllama-1.1b"))
    run4 = _port_run("overlap_int8_ring_cs")
    state = init_train_state(0, cfg, run4, device="cpu")
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    step = make_dp_train_step(cfg, run4)
    for _ in range(2):
        state, _ = step(state, {"tokens": tokens, "labels": tokens})
    ck = Checkpointer(str(tmp_path), keep=2)
    loop_mod.save_state(ck, 2, state, run4)
    meta = ck.metadata()
    assert meta["residual_layout"] == "per_worker_v1"
    assert meta["dp_workers"] == W
    fresh = init_train_state(1, cfg, run4, device="cpu")
    back, _ = loop_mod.restore_state(ck, fresh, run4)
    for k in ("u", "v"):
        assert torch.equal(back.opt["err"][k], state.opt["err"][k])
    for n in state.opt["sketch_err"]:
        for a in "xyz":
            assert torch.equal(back.opt["sketch_err"][n][a],
                               state.opt["sketch_err"][n][a])
    run2 = dataclasses.replace(run4, dp_workers=2)
    fresh2 = init_train_state(1, cfg, run2, device="cpu")
    back2, _ = loop_mod.restore_state(ck, fresh2, run2)
    for old, new in [(state.opt["err"][k], back2.opt["err"][k])
                     for k in ("u", "v")] + [
            (state.opt["sketch_err"][n][a], back2.opt["sketch_err"][n][a])
            for n in state.opt["sketch_err"] for a in "xyz"]:
        assert new.shape == (2,) + old.shape[1:]
        assert torch.equal(new[0], new[1])
        assert torch.equal(new[0], old.sum(0) / 2)
    assert torch.equal(FlatLayout(back2.params).ravel(back2.params),
                       FlatLayout(state.params).ravel(state.params))


@pytest.mark.parametrize("layout", ["fused", "overlap"])
def test_p2_overlap_is_the_serial_step_bitwise(layout):
    """The p2 round beside the optimizer (the zero-gradient AdamW pass,
    then the k winners recomputed) gives the serial finish-then-AdamW
    step's state and metrics bit for bit, as the reference's does."""
    cfg = reduced(get_arch("tinyllama-1.1b"))
    gen = torch.Generator().manual_seed(4)
    batches = [torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
               for _ in range(3)]
    out = {}
    for p2o in (False, True):
        run = RunConfig(**RUN_KW, dp_collective=layout, p2_overlap=p2o,
                        optimizer=AdamWConfig(lr=1e-3),
                        sketch=SketchSettings(enabled=True, k_max=K_MAX),
                        compression=CompressionConfig(**dict(CS, cs_p2=2)))
        state = init_train_state(0, cfg, run, device="cpu")
        step = make_dp_train_step(cfg, run)
        for tok in batches:
            state, m = step(state, {"tokens": tok, "labels": tok})
        out[p2o] = (state, m)
    (a, ma), (b, mb) = out[False], out[True]
    lay = FlatLayout(a.params)
    assert torch.equal(lay.ravel(a.params), lay.ravel(b.params))
    for k in ("m", "v"):
        assert torch.equal(lay.ravel(a.opt[k]), lay.ravel(b.opt[k]))
    for k in ("u", "v"):
        assert torch.equal(a.opt["err"][k], b.opt["err"][k])
    assert all(float(ma[k]) == float(mb[k]) for k in ("loss", "grad_norm"))
