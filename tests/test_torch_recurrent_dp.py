"""xlstm-1.3b and recurrentgemma-2b trained data-parallel and with
count-sketch compression in the port, against the JAX package, on the
CPU.

The configs are the reduced ones (``reduced``: d 64, f32):
recurrentgemma's 3 layers (two RG-LRU, one local), and xlstm's 7:1
pattern cut to 2:1 (two mLSTM layers, one sLSTM: the reference compiles
each pattern position of a step apart, about 17.5 s a step function at
8 layers and 6 s at 3). Sketched backprop at k_max 9, beta 0.9, beside
the carry nodes "mlstm_c"/"mlstm_n" (the mLSTM layers only) and
"rglru_h" (the RG-LRU layers).

Data parallel: W 2 workers, global batch 4, 2 steps, in the fused
layout and per_node for both archs, and overlap for recurrentgemma (the
psum; ``test_torch_dp.py`` holds the ring wire, whose Pallas kernel the
reference compiles in interpret mode for seconds a step function); and
reduced internvl2-76b fused with patch embeddings in every batch, which
the step splits over the workers with the tokens. The psparse runs
(xlstm per_node, recurrentgemma overlap) take global B 4 x S 128, so
each worker's binding is 256 tokens, from PRNGKey(6): the psparse draw
ROADMAP section C names full-rank at that binding (the reference's
multiply-shift signs are rank-deficient for most draws;
``test_psparse_runs_have_full_rank_projections`` checks it); the rest
take S 16 from PRNGKey(0).
Compression: one device, B 2 x S 16, 2 steps each with the fp32 count
sketch and with the int8 table and the p2 round.

The reference runs in ONE subprocess with 2 forced host devices for the
whole module (``reference_runs``), as ``test_torch_dp.py`` runs its: it
writes each run's initial state, its batches, every step's metrics,
count-sketch selections and the state after it, and the DP runs'
collective traces (recorded while the first call traces the step) and
plans into one .npz. Each of the
port's steps starts from the reference's state before it
(``port_state``), so a step's differences do not compound. Tolerances:
losses and gradient norms rtol 1e-5; AdamW moments, every sketch triple
(the carry nodes' included) and each worker's {u, v} rtol 1e-5, atol
1e-5 of max; parameters the same plus the first moment's tolerance
carried through the AdamW step (lr m_hat / (sqrt(v_hat) + eps)
multiplies it by up to lr / eps where the gradient is tiny); every
count-sketch nomination and selection equal.

A flat dimension of 2**31 or more is past what the reference can index
(int32): its step raises OverflowError while tracing, and the port
raises ValueError naming the limit before allocating anything.
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

from repro_torch import interop
from repro_torch.configs import get_arch, reduced
from repro_torch.models.transformer import SketchSettings
from repro_torch.optim import sketched_sgd as TS
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compression import CompressionConfig
from repro_torch.optim.flat import FlatLayout
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.parallel.collectives import collective_trace
from repro_torch.train.state import RunConfig, init_train_state
from repro_torch.train.step import collective_plan, make_train_step
from test_torch_dp import _close, _of_max, _params, _sub, _tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, K_MAX, BETA, LR, TOL = 2, 9, 0.9, 1e-3, 1e-5
CS = dict(mode="countsketch", cs_rows=5, cs_cols=512, cs_k=64,
          cs_momentum=0.0)
XL, RG = "xlstm-1.3b", "recurrentgemma-2b"


# reduced xlstm's 7:1 pattern cut to 2:1 (3 layers): the reference
# compiles every pattern position of its step apart, 17.5 s a step
# function at 8 layers and 6 s at 3 (on an 8-core CPU)
XL_CUT = dict(pattern=["mlstm", "mlstm", "slstm"], num_layers=3)


def _run(arch, *, workers=1, batch=2, seq=16, key=0, proj="gaussian",
         cs=None, patch=False, **run_kw):
    return dict(arch=arch, cut=XL_CUT if arch == XL else {},
                workers=workers, batch=batch, seq=seq, key=key, proj=proj,
                cs=cs, patch=patch, run=run_kw)


def _cut(cfg, cut: dict):
    """``cfg`` with the run's cut applied (a JSON list as a tuple)."""
    return dataclasses.replace(cfg, **{k: tuple(v) if isinstance(v, list)
                                       else v for k, v in cut.items()})


# name -> run; "dp/" runs are W-worker shard_map steps, "cs/" one device
RUNS = {
    "dp/xlstm_fused": _run(XL, workers=2, batch=4, dp_collective="fused"),
    "dp/xlstm_per_node": _run(XL, workers=2, batch=4, seq=128, key=6,
                              proj="psparse", dp_collective="per_node"),
    "dp/rgemma_fused": _run(RG, workers=2, batch=4, dp_collective="fused"),
    "dp/rgemma_per_node": _run(RG, workers=2, batch=4,
                               dp_collective="per_node"),
    "dp/rgemma_overlap": _run(RG, workers=2, batch=4, seq=128, key=6,
                              proj="psparse", dp_collective="overlap"),
    # internvl2-76b's patch embeddings split over the workers with the
    # tokens (test_torch_frontends.py holds its single-device steps)
    "dp/internvl2_fused": _run("internvl2-76b", workers=2, batch=4,
                               patch=True, dp_collective="fused"),
    "cs/xlstm_fp32": _run(XL, cs=CS),
    "cs/xlstm_int8_p2": _run(XL, cs=dict(CS, wire_dtype="int8", cs_p2=2)),
    "cs/rgemma_fp32": _run(RG, cs=CS),
    "cs/rgemma_int8_p2": _run(RG, cs=dict(CS, wire_dtype="int8", cs_p2=2)),
}

REF_CODE = """
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.checkpoint.checkpointer import gather_per_worker
    from repro.configs import get_arch, reduced
    from repro.data.synthetic import lm_batch
    from repro.models.frontends import fake_patch_embeds
    from repro.models.transformer import SketchSettings
    from repro.optim import sketched_sgd as JS
    from repro.optim.adamw import AdamWConfig
    from repro.optim.compression import CompressionConfig
    from repro.parallel.collectives import collective_trace
    from repro.train.state import RunConfig, init_train_state
    from repro.train.step import (collective_plan, make_dp_train_step,
                                  make_train_step)

    RUNS, STEPS, K_MAX, BETA, LR = json.loads(sys.argv[2])
    out = {}
    sel = []
    orig_cc, orig_rc = JS.countsketch_complete, JS._recover_candidates

    def cc(*a, **kw):
        res = orig_cc(*a, **kw)
        jax.debug.callback(lambda i: sel.append(("sel", np.asarray(i))),
                           res[1])
        return res

    def rc(*a, **kw):
        res = orig_rc(*a, **kw)
        jax.debug.callback(lambda i: sel.append(("cand", np.asarray(i))),
                           res[1])
        return res

    JS.countsketch_complete, JS._recover_candidates = cc, rc

    def put(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)

    for name, r in RUNS.items():
        cfg = dataclasses.replace(reduced(get_arch(r["arch"])), **{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in r["cut"].items()})
        W, B, S = r["workers"], r["batch"], r["seq"]
        dp = W > 1
        ckw = r["cs"]
        run = RunConfig(
            seq_len=S, global_batch=B, warmup_steps=2, total_steps=10,
            optimizer=AdamWConfig(lr=LR), **r["run"],
            **(dict(dp_axis_name="data", dp_workers=W) if dp else {}),
            sketch=SketchSettings(enabled=True, k_max=K_MAX, beta=BETA,
                                  proj_kind=r["proj"]),
            compression=CompressionConfig(**ckw) if ckw else None)
        key = jax.random.PRNGKey(r["key"])
        state = init_train_state(key, cfg, run)
        proj = state.sketch.proj
        if hasattr(proj, "params"):
            out[name + "/psparse"] = np.asarray(proj.params)
            out[name + "/psparse_meta"] = np.asarray(
                [proj.num_tokens, proj.k_max, proj.density])
        else:
            put(name + "/proj", proj)
        put(name + "/psi", {n: v.psi for n, v in state.sketch.nodes.items()})
        out[name + "/rank"] = np.asarray(state.sketch.rank)
        if ckw:
            out[name + "/cs_params"] = np.asarray(JS.grad_csvec(
                run.compression, JS.flat_dim(state.params)).params)
        if dp:
            mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
            state = jax.device_put(state, NamedSharding(mesh, P()))
            step = jax.jit(make_dp_train_step(cfg, run, mesh))
        else:
            step = jax.jit(make_train_step(cfg, run))

        def dump(s):
            pre = f"{name}/state{s}/"
            put(pre + "params", state.params)
            put(pre + "opt", {k: v for k, v in state.opt.items()
                              if k not in ("err", "sketch_err")})
            put(pre + "nodes", {n: (v.x, v.y, v.z)
                                for n, v in state.sketch.nodes.items()})
            if "err" in state.opt:
                put(pre + "err", gather_per_worker(state.opt["err"], mesh,
                                                   "data")
                    if dp else jax.tree.map(lambda a: a[None],
                                            state.opt["err"]))

        def batch(s):
            tok, lab = lm_batch(jax.random.fold_in(key, s), B, S,
                                cfg.vocab_size)
            b = {"tokens": tok, "labels": lab}
            if r["patch"]:
                b["patch_embeds"] = fake_patch_embeds(
                    jax.random.fold_in(key, 1000 + s), B,
                    cfg.num_frontend_tokens, cfg.d_model, cfg.dtype)
            return b

        dump(0)
        if dp:
            out[name + "/plan"] = np.asarray(json.dumps(
                collective_plan(cfg, run)))
        for s in range(STEPS):
            b = batch(s)
            for k, v in b.items():
                out[f"{name}/batch{s}/{k}"] = np.asarray(v)
            sel.clear()
            # the first call traces the step, recording its collectives
            with collective_trace() as log:
                state, m = step(state, b)
            if dp and s == 0:
                out[name + "/trace"] = np.asarray(json.dumps(log))
            jax.block_until_ready(state)
            jax.effects_barrier()
            for k in ("loss", "grad_norm", "skipped_total"):
                out[f"{name}/step{s}/{k}"] = np.asarray(m[k])
            for kind in ("cand", "sel"):
                got = [i for k, i in sel if k == kind]
                if got:
                    assert len(got) == W and all(
                        np.array_equal(got[0], x) for x in got), len(got)
                    out[f"{name}/step{s}/{kind}"] = got[0]
            dump(s + 1)
        print(name, "done", flush=True)
    np.savez(sys.argv[1], **out)
    print("OK")
"""


def reference_runs(runs: dict, devices: int = 2) -> dict:
    """The reference's ``runs`` (``_run`` dicts) from one subprocess with
    ``devices`` forced host devices, as one dict of numpy arrays."""
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ref.npz")
        proc = subprocess.run(
            [sys.executable, "-c", textwrap.dedent(REF_CODE), path,
             json.dumps([runs, STEPS, K_MAX, BETA, LR])],
            capture_output=True, text=True, env=env, timeout=900)
        assert proc.returncode == 0, proc.stderr[-4000:]
        with np.load(path) as z:
            return {k: z[k] for k in z.files}


def port_config(r: dict):
    """(cfg, RunConfig) of the port for the ``_run`` dict ``r``."""
    cfg = _cut(reduced(get_arch(r["arch"])), r["cut"])
    dp = r["workers"] > 1
    run = RunConfig(
        seq_len=r["seq"], global_batch=r["batch"], warmup_steps=2,
        total_steps=10, optimizer=AdamWConfig(lr=LR), **r["run"],
        **(dict(dp_axis_name="data", dp_workers=r["workers"]) if dp else {}),
        sketch=SketchSettings(enabled=True, k_max=K_MAX, beta=BETA,
                              proj_kind=r["proj"]),
        compression=CompressionConfig(**r["cs"]) if r["cs"] else None)
    return cfg, run


def _proj(ref, name):
    if name + "/psparse" in ref:
        n, k, p = ref[name + "/psparse_meta"]
        return types.SimpleNamespace(params=ref[name + "/psparse"],
                                     num_tokens=int(n), k_max=int(k),
                                     density=float(p))
    return _tree(_sub(ref, name + "/proj"))[""]


def port_state(ref, name, s, cfg, run):
    """The port's state from the reference's after ``s`` steps: weights,
    tree (dense or psparse projections), AdamW moments and each worker's
    {u, v}."""
    st = _tree(_sub(ref, f"{name}/state{s}/"))
    psi = _tree(_sub(ref, name + "/psi"))[""]
    nodes = {n: types.SimpleNamespace(x=v[0], y=v[1], z=v[2], psi=psi[n])
             for n, v in st["nodes"].items()}
    jtree = types.SimpleNamespace(nodes=nodes, proj=_proj(ref, name),
                                  rank=ref[name + "/rank"], step=s, epoch=0)
    state = init_train_state(0, cfg, run, device="cpu",
                             params=_params(st["params"]),
                             sketch=interop.tree_from_jax(jtree))
    opt = {"m": _params(st["opt"]["m"]), "v": _params(st["opt"]["v"]),
           "count": torch.from_numpy(st["opt"]["count"]).int()}
    if "err" in st:
        err = interop.error_feedback_from_jax(st["err"])
        opt["err"] = err if run.dp_axis_name else {k: v[0]
                                                   for k, v in err.items()}
    return dataclasses.replace(state, opt=opt, step=s)


def port_batch(ref, name, s):
    out = {k: torch.from_numpy(ref[f"{name}/batch{s}/{k}"]).long()
           for k in ("tokens", "labels")}
    if f"{name}/batch{s}/patch_embeds" in ref:
        out["patch_embeds"] = torch.from_numpy(
            ref[f"{name}/batch{s}/patch_embeds"])
    return out


def port_runs(ref, runs: dict) -> dict:
    """Each of the port's steps of every run from the reference's state
    before it, with its selections and collective trace."""
    out = {}
    for name, r in runs.items():
        cfg, run = port_config(r)
        cs_params = None
        if name + "/cs_params" in ref:
            cs_params = interop.csvec_params_from_jax(ref[name + "/cs_params"])
        step = make_train_step(cfg, run, cs_params=cs_params)
        sels, metrics, traces, states = [], [], [], []
        orig_rc, orig_sel = TS._recover_candidates, TS._select

        def rc(*a, **kw):
            res = orig_rc(*a, **kw)
            sels[-1]["cand"] = res[1].numpy()
            return res

        def select(*a, **kw):
            res = orig_sel(*a, **kw)
            sels[-1]["sel"] = res[0].numpy()
            return res

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TS, "_recover_candidates", rc)
            mp.setattr(TS, "_select", select)
            for s in range(STEPS):
                sels.append({})
                with collective_trace() as log:
                    state, m = step(port_state(ref, name, s, cfg, run),
                                    port_batch(ref, name, s))
                metrics.append(m)
                traces.append(log)
                states.append(state)
        out[name] = dict(states=states, metrics=metrics, sels=sels,
                         traces=traces, cfg=cfg, run=run)
    return out


def check_steps(ref, pr, name):
    """Every step of run ``name`` against the reference's (the
    module docstring's tolerances)."""
    run = pr["run"]
    for s in range(STEPS):
        what = f"{name} step {s}"
        m, state = pr["metrics"][s], pr["states"][s]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]),
                                       float(ref[f"{name}/step{s}/{k}"]),
                                       rtol=TOL, err_msg=f"{what} {k}")
        assert m["skipped_total"] == 0 == ref[f"{name}/step{s}/skipped_total"]
        want = _tree(_sub(ref, f"{name}/state{s + 1}/"))
        wp = _params(want["params"])
        lay = FlatLayout(wp)
        mom = {k: lay.ravel(_params(want["opt"][k])).numpy()
               for k in ("m", "v")}
        for k, wk in mom.items():
            _close(lay.ravel(state.opt[k]), wk, TOL, _of_max(wk, TOL),
                   f"{what} {k}")
        lr = LR * warmup_cosine(s, warmup_steps=2, total_steps=10)
        b1c, b2c = 1 - 0.9 ** (s + 1), 1 - 0.95 ** (s + 1)
        carried = lr * (TOL * np.abs(mom["m"]) + _of_max(mom["m"], TOL)) / (
            b1c * (np.sqrt(mom["v"] / b2c) + 1e-8))
        want_p = lay.ravel(wp).numpy()
        diff = np.abs(lay.ravel(state.params).numpy() - want_p)
        bad = diff > TOL * np.abs(want_p) + _of_max(want_p, TOL) + carried
        assert not bad.any(), (what, "params", np.flatnonzero(bad)[:5],
                               diff[bad][:5])
        assert state.sketch.step == s + 1
        assert sorted(state.sketch.nodes) == sorted(want["nodes"])
        for n, leaves in want["nodes"].items():
            for a, w in zip("xyz", leaves):
                _close(getattr(state.sketch.nodes[n], a), w, TOL,
                       _of_max(w, TOL), f"{what} tree {n}.{a}")
        if "err" in want:
            for k in ("u", "v"):
                w = want["err"][k]
                got = state.opt["err"][k]
                _close(got if run.dp_axis_name else got[None], w, TOL,
                       _of_max(w, TOL), f"{what} err {k}")
        for kind in ("cand", "sel"):
            key = f"{name}/step{s}/{kind}"
            if key in ref:
                np.testing.assert_array_equal(pr["sels"][s][kind], ref[key],
                                              err_msg=f"{what} {kind}")
            else:
                assert kind not in pr["sels"][s], (what, kind)


def check_trace(ref, pr, name):
    """The port's collective trace: the reference's own where it records
    every collective (the flat-segment layouts), else the count and
    bytes of its plan; and the port's plan equal to the reference's."""
    plan = json.loads(str(ref[name + "/plan"]))
    trace = json.loads(str(ref[name + "/trace"]))
    for log in pr["traces"]:
        if pr["run"].dp_collective == "per_node":
            assert len(log) == plan["collectives"]
            assert sum(r["bytes"] for r in log) == plan["wire_bytes"]
        else:
            assert log == trace
    mine = collective_plan(pr["cfg"], pr["run"])
    for k in ("layout", "collectives", "wire_bytes", "by_kind", "ring_wire",
              "sketch_wire_dtype", "p2_overlap"):
        assert mine[k] == plan[k], k


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the steps are many small ops, and the other
    xdist workers share the cores. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    return reference_runs(RUNS)


@pytest.fixture(scope="module")
def port(ref):
    return port_runs(ref, RUNS)


@pytest.mark.parametrize("name", list(RUNS))
def test_steps_match_reference(ref, port, name):
    check_steps(ref, port[name], name)


@pytest.mark.parametrize("name", [n for n in RUNS if n.startswith("dp/")])
def test_collective_trace_matches_both_plans(ref, port, name):
    check_trace(ref, port[name], name)


@pytest.mark.parametrize("name", [n for n in RUNS if n.startswith("cs/")])
def test_compressed_steps_select_the_reference_coordinates(ref, port, name):
    """Every step nominated and selected coordinates, the reference's
    (with p2: the candidates, then the k winners among them)."""
    p2 = RUNS[name]["cs"].get("cs_p2", 0) > 0
    for s in range(STEPS):
        assert sorted(port[name]["sels"][s]) == (["cand", "sel"] if p2
                                                 else ["cand"])
        assert sorted(k.rsplit("/", 1)[1] for k in ref
                      if k.startswith(f"{name}/step{s}/")
                      and k.endswith(("cand", "sel"))) == sorted(
            port[name]["sels"][s])


def test_psparse_runs_have_full_rank_projections(ref):
    """The psparse runs' three implicit matrices have full rank over the
    active columns (ROADMAP section C), so the sketched backward is
    well posed on both sides."""
    for name in (n for n, r in RUNS.items() if r["proj"] == "psparse"):
        proj = interop.proj_from_jax(_proj(ref, name))
        k = 2 * int(ref[name + "/rank"]) + 1
        for n in ("upsilon", "omega", "phi"):
            assert int(torch.linalg.matrix_rank(proj[n][:, :k])) == k, \
                (name, n)


@pytest.mark.parametrize("arch", [XL, RG])
def test_carry_nodes_ride_the_wire_in_the_references_stack_shapes(arch):
    """The carry nodes' increments on the wire: (entries, width, k)
    stacks, one entry an mLSTM or RG-LRU layer, as the reference's
    registry gives them."""
    from repro.configs import get_arch as jax_get_arch
    from repro.configs import reduced as jax_reduced
    from repro.sketches.registry import node_specs_for as jax_specs
    from repro_torch.sketches.registry import node_specs_for
    from repro_torch.sketches.wire import tree_increment_leaves

    for cfg, jcfg in ((get_arch(arch), jax_get_arch(arch)),
                      (reduced(get_arch(arch)),
                       jax_reduced(jax_get_arch(arch)))):
        want = jax_specs(jcfg)
        got = node_specs_for(cfg)
        assert sorted(got) == sorted(want)
        for n, spec in want.items():
            assert (got[n].width, got[n].layers) == (spec.width, spec.layers)
    cfg = reduced(get_arch(arch))
    run = RunConfig(seq_len=16, global_batch=4, dp_axis_name="data",
                    dp_workers=2, sketch=SketchSettings(enabled=True,
                                                        k_max=K_MAX))
    state = init_train_state(0, cfg, run, device="cpu")
    leaves = tree_increment_leaves(state.sketch)
    for n, spec in node_specs_for(cfg).items():
        for a in "xyz":
            assert tuple(leaves[n][a].shape) == (spec.layers, spec.width,
                                                 K_MAX), (n, a)


@pytest.mark.parametrize("dim", [2**31 - 1, 2**31, 2**31 + 5])
def test_flat_dimension_past_int32_raises(dim):
    """At 2**31 coordinates or more the reference's step does not trace
    (its indices are int32); the port's count sketch raises ValueError
    naming the limit, before any allocation. Below it both go on."""
    import jax
    import jax.numpy as jnp
    from repro.optim import sketched_sgd as JS
    from repro.optim.compression import CompressionConfig as JCompression
    from repro_torch.optim.compression import resolve_countsketch

    jcfg = JCompression(mode="countsketch", cs_rows=5, cs_cols=1024, cs_k=8)
    g = jax.ShapeDtypeStruct((dim,), jnp.float32)
    fits = dim < 2**31
    try:
        jax.eval_shape(lambda gr, er: JS.compress_grads_countsketch(
            {"w": gr}, er, jcfg), g, {"u": g, "v": g})
        ref_ok = True
    except OverflowError:
        ref_ok = False
    assert ref_ok == fits
    cfg = CompressionConfig(mode="countsketch", cs_rows=5, cs_cols=1024,
                            cs_k=8)
    if fits:
        assert resolve_countsketch(cfg, dim).cs_cols == 1024
        return
    with pytest.raises(ValueError, match=r"2\*\*31 - 1"):
        resolve_countsketch(cfg, dim)
    # a whole model: recurrentgemma-2b at its 26 layers (2.89e9
    # coordinates) refuses the count sketch at the run's setup
    with pytest.raises(ValueError, match=r"2\*\*31 - 1"):
        make_train_step(get_arch(RG), RunConfig(
            seq_len=16, global_batch=2, compression=CompressionConfig(**CS)))
