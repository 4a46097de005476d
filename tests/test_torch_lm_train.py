"""The port's LM trainer against the JAX reference, on the CPU, at the
reduced tinyllama-1.1b (2 layers, d 64, 4/2 heads, d_ff 128, vocab 256;
f32), B=4 x S=16, sketched backprop at k_max 9.

Both packages get the same numbers: weights, sketch trees, optimizer
state and batches are made on the JAX side and carried over with
``repro_torch.interop``, and the count sketch takes the reference's hash
coefficients. Tolerances (f32 on both sides, sums in other orders):
  * one sketched step: loss rtol 1e-6; gradients rtol 1e-4, atol 1e-5 *
    max|reference| (the reconstruction's k x k solves amplify
    rounding); the new sketch tree rtol 1e-5, atol 1e-6 * max;
  * 8-step trajectories: losses rtol 1e-5; the error feedback (u and
    v, or top-k's residual tree) atol 1e-5 * its max; parameters atol
    1e-6 after 8 AdamW steps of lr 1e-3. The top-k run sends f32 values:
    with int8 values, a value that lands near a rounding boundary of the
    grid takes the next code in one package (seen at this seed), which
    ``test_topk_compression_matches_reference`` covers exactly. The
    count sketch's candidates and selected coordinates exactly, after
    checking at every selection that the k-th and (k+1)-th magnitudes
    lie further apart than 1e-5 of the largest (the tables differ in
    summation order) or are equal: an exact f32 tie of two medians is
    one table entry shared by both coordinates, which both packages
    hold alike and break toward the smaller index.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.models.transformer import SketchSettings as JSketchSettings
from repro.models.transformer import forward as jax_forward
from repro.optim import sketched_sgd as JS
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.optim.compression import CompressionConfig as JCompressionConfig
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine
from repro.train.state import RunConfig as JRunConfig
from repro.train.state import init_train_state as jax_init_train_state
from repro.train.step import cross_entropy as jax_cross_entropy
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import interop
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_arch, reduced
from repro_torch.data.synthetic import lm_batch
from repro_torch.core.adaptive import AdaptiveConfig
from repro_torch.launch import train as train_launcher
from repro_torch.train import loop as loop_mod
from repro_torch.models.transformer import (
    SketchSettings, flat_paths, forward, init_params, num_params,
)
from repro_torch.optim import sketched_sgd as TS
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.compression import CompressionConfig
from repro_torch.optim.flat import FlatLayout
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.state import RunConfig, init_train_state
from repro_torch.train.step import cross_entropy, make_train_step

B, S, K_MAX, STEPS = 4, 16, 9, 8
RUN_KW = dict(seq_len=S, global_batch=B, warmup_steps=2, total_steps=STEPS)
CS_KW = dict(mode="countsketch", cs_rows=5, cs_cols=2048, cs_k=64)
MODES = {"none": None,
         "fp32": dict(CS_KW),
         "int8_p2": dict(CS_KW, cs_p2=2, wire_dtype="int8"),
         "topk": dict(mode="topk", topk_frac=0.05, int8=False)}
MARGIN = 1e-5


def _np(t):
    return np.asarray(jax.device_get(t)) if not isinstance(t, torch.Tensor) \
        else t.detach().cpu().numpy()


def _tree_np(tree):
    return jax.tree.map(_np, tree)


def _cfgs():
    return (jax_reduced(jax_get_arch("tinyllama-1.1b")),
            reduced(get_arch("tinyllama-1.1b")))


def _runs(mode):
    ckw = MODES[mode]
    jrun = JRunConfig(**RUN_KW, optimizer=JAdamWConfig(lr=1e-3),
                      sketch=JSketchSettings(enabled=True, k_max=K_MAX),
                      compression=JCompressionConfig(**ckw) if ckw else None)
    trun = RunConfig(**RUN_KW, optimizer=AdamWConfig(lr=1e-3),
                     sketch=SketchSettings(enabled=True, k_max=K_MAX),
                     compression=CompressionConfig(**ckw) if ckw else None)
    return jrun, trun


def _batch(i, vocab):
    tok, lab = jax_lm_batch(jax.random.fold_in(jax.random.PRNGKey(1), i), B,
                            S, vocab)
    return ({"tokens": tok, "labels": lab},
            {"tokens": torch.tensor(_np(tok), dtype=torch.int64),
             "labels": torch.tensor(_np(lab), dtype=torch.int64)})


def _jax_err(err):
    """Error feedback as one vector: countsketch's u then v, top-k's
    tree raveled as the reference ravels it."""
    if err is None:
        return None
    if set(err) == {"u", "v"}:
        return np.concatenate([_np(err["u"]), _np(err["v"])])
    return _np(ravel_pytree(err)[0])


def _port_err(err, tcfg):
    if err is None:
        return None
    if set(err) == {"u", "v"}:
        return torch.cat([err["u"], err["v"]])
    return FlatLayout(err, flat_paths(err, tcfg)).ravel(err)


def _port_state(jstate, tcfg, trun):
    """The port's state from the reference's: weights, tree, AdamW."""
    st = init_train_state(
        0, tcfg, trun, device="cpu",
        params=interop.params_from_jax(_tree_np(jstate.params)),
        sketch=interop.tree_from_jax(_tree_np(jstate.sketch)))
    opt = interop.adamw_state_from_jax(_tree_np(
        {k: v for k, v in jstate.opt.items() if k != "err"}))
    if "err" in jstate.opt:
        opt["err"] = interop.error_feedback_from_jax(
            _tree_np(jstate.opt["err"]))
    return dataclasses.replace(st, opt=opt)


@pytest.fixture(scope="module")
def trajectories():
    """Each mode's 8-step reference and port trajectories, with every
    count-sketch selection both packages made (the reference's recorded
    through jax.debug.callback) and the port's selection margins."""
    jcfg, tcfg = _cfgs()
    out = {}
    for mode in MODES:
        jrun, trun = _runs(mode)
        jstate = jax_init_train_state(jax.random.PRNGKey(0), jcfg, jrun)
        state = _port_state(jstate, tcfg, trun)
        jsel, tsel, margins = [], [], []
        with pytest.MonkeyPatch.context() as mp:
            orig_rc, orig_cc = JS._recover_candidates, JS.countsketch_complete

            def jrc(cs, k, cfg):
                vals, idx = orig_rc(cs, k, cfg)
                jax.debug.callback(lambda i: jsel.append(np.asarray(i)), idx)
                return vals, idx

            def jcc(*a, **kw):
                res = orig_cc(*a, **kw)
                jax.debug.callback(lambda i: jsel.append(np.asarray(i)),
                                   res[1])
                return res

            mp.setattr(JS, "_recover_candidates", jrc)
            mp.setattr(JS, "countsketch_complete", jcc)
            t_rc, t_sel = TS._recover_candidates, TS.select_topk

            def trc(cs, k, cfg):
                vals, idx = t_rc(cs, min(k + 1, cs.dim), cfg)
                mags = vals.abs()
                margins.append(float((mags[k - 1] - mags[k])
                                     / mags.max()))
                tsel.append(idx[:k].numpy())
                return vals[:k], idx[:k]

            def tsel_fn(mag, k):
                srt = torch.sort(mag, descending=True).values
                margins.append(float((srt[k - 1] - srt[k]) / srt[0]))
                pos = t_sel(mag, k)
                return pos

            def tcc(local, merged, cand, exact, *, workers):
                res = orig_tcc(local, merged, cand, exact, workers=workers)
                tsel.append(res[1].numpy())
                return res

            orig_tcc = TS.countsketch_complete
            mp.setattr(TS, "_recover_candidates", trc)
            mp.setattr(TS, "select_topk", tsel_fn)
            mp.setattr(TS, "countsketch_complete", tcc)
            jstep = jax.jit(jax_make_train_step(jcfg, jrun))
            cs_params = None
            if mode in ("fp32", "int8_p2"):
                cs_params = interop.csvec_params_from_jax(JS.grad_csvec(
                    jrun.compression, JS.flat_dim(jstate.params)).params)
            tstep = make_train_step(tcfg, trun, cs_params=cs_params)
            hist = []
            for i in range(STEPS):
                jb, tb = _batch(i, jcfg.vocab_size)
                jstate, jm = jstep(jstate, jb)
                jax.block_until_ready(jstate)
                state, tm = tstep(state, tb)
                hist.append((jax.tree.map(_np, jm), tm,
                             _jax_err(jstate.opt.get("err")),
                             _port_err(state.opt.get("err"), tcfg)))
        out[mode] = dict(hist=hist, jstate=jstate, state=state, jsel=jsel,
                         tsel=tsel, margins=margins)
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_trajectory_matches_reference(trajectories, mode):
    tr = trajectories[mode]
    for jm, tm, jerr, terr in tr["hist"]:
        np.testing.assert_allclose(float(tm["loss"]), jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), jm["grad_norm"],
                                   rtol=1e-4)
        assert tm["lr_scale"] == pytest.approx(float(jm["lr_scale"]),
                                               rel=1e-6)
        assert tm["skipped_total"] == int(jm["skipped_total"]) == 0
        if jerr is not None:
            np.testing.assert_allclose(_np(terr), jerr, rtol=0,
                                       atol=MARGIN * np.abs(jerr).max())
    want = interop.params_from_jax(_tree_np(tr["jstate"].params))
    got = FlatLayout(want).ravel(tr["state"].params)
    np.testing.assert_allclose(got.numpy(),
                               FlatLayout(want).ravel(want).numpy(),
                               rtol=0, atol=1e-6)
    assert tr["state"].step == STEPS and tr["state"].sketch.step == STEPS


@pytest.mark.parametrize("mode", ["fp32", "int8_p2"])
def test_countsketch_selects_the_reference_coordinates(trajectories, mode):
    tr = trajectories[mode]
    per_step = 2 if mode == "int8_p2" else 1
    assert len(tr["jsel"]) == len(tr["tsel"]) == per_step * STEPS
    assert all(m > MARGIN or m == 0.0 for m in tr["margins"]), tr["margins"]
    for want, got in zip(tr["jsel"], tr["tsel"]):
        np.testing.assert_array_equal(got, want)


def test_flat_order_is_the_references_ravel():
    jcfg, tcfg = _cfgs()
    from repro.models.transformer import init_params as jax_init_params
    jparams = _tree_np(jax_init_params(jax.random.PRNGKey(3), jcfg))
    params = interop.params_from_jax(jparams)
    layout = FlatLayout(params, flat_paths(params, tcfg))
    flat = layout.ravel(params)
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(ravel_pytree(jparams)[0]))
    assert layout.dim == num_params(tcfg) == TS.flat_dim(params)
    views = layout.unravel(flat)
    lo, hi = flat.data_ptr(), flat.data_ptr() + 4 * flat.numel()
    for leaf in jax.tree.leaves(views):
        assert lo <= leaf.data_ptr() < hi
    views["layers"][1]["mlp"]["w_up"][0, 0] = 123.0
    assert 123.0 in flat


@pytest.mark.parametrize("name", ["gemma3-27b", "granite-34b"])
def test_flat_order_with_a_pattern_and_tail(name):
    """gemma3's six-layer pattern over 8 layers: one full group and a
    tail of two, as the reference stacks them."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(name)), num_layers=8)
    tcfg = dataclasses.replace(reduced(get_arch(name)), num_layers=8)
    from repro.models.transformer import init_params as jax_init_params
    jparams = _tree_np(jax_init_params(jax.random.PRNGKey(3), jcfg))
    params = interop.params_from_jax(jparams)
    flat = FlatLayout(params, flat_paths(params, tcfg)).ravel(params)
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(ravel_pytree(jparams)[0]))


def test_one_sketched_step_grads_and_tree_match_reference():
    jcfg, tcfg = _cfgs()
    jrun, trun = _runs("none")
    jstate = jax_init_train_state(jax.random.PRNGKey(5), jcfg, jrun)
    state = _port_state(jstate, tcfg, trun)
    jb, tb = _batch(0, jcfg.vocab_size)

    def loss_fn(params, sketch):
        out = jax_forward(params, jb["tokens"], cfg=jcfg, mode="train",
                          sketch_state=sketch, settings=jrun.sketch)
        ce = jax_cross_entropy(out["logits"], jb["labels"], jrun.z_weight)
        return ce + jrun.aux_weight * out["aux"], out["sketch_state"]

    (jloss, jtree), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jstate.params, jstate.sketch)
    loss, ce, aux, grads, tree = make_train_step(
        tcfg, trun).loss_and_grads(state, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    want = interop.params_from_jax(_tree_np(jgrads))
    lay = FlatLayout(want)
    for g, w in zip(lay.unravel(lay.ravel(grads)).values(), want.values()):
        for gl, wl in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            scale = float(wl.abs().max())
            torch.testing.assert_close(gl, wl, rtol=1e-4, atol=1e-5 * scale)
    wtree = interop.tree_from_jax(_tree_np(jtree))
    assert tree.step == wtree.step == 1
    for name in ("ffn_in", "ffn_h"):
        for a in ("x", "y", "z"):
            w = getattr(wtree.nodes[name], a)
            torch.testing.assert_close(getattr(tree.nodes[name], a), w,
                                       rtol=1e-5,
                                       atol=1e-6 * float(w.abs().max()))


def test_one_psparse_sketched_step_grads_and_tree_match_reference():
    """The same with psparse projections (density 0.1) at S 64, so the
    tree binds 256 tokens and each projection column reads 25 of them:
    the reference's seeds-only tree carried over, the psparse update's
    plain version against the reference's jnp path."""
    Bp, Sp = 4, 64
    jcfg, tcfg = _cfgs()
    kw = dict(seq_len=Sp, global_batch=Bp, warmup_steps=2, total_steps=STEPS)
    jrun = JRunConfig(**kw, optimizer=JAdamWConfig(lr=1e-3),
                      sketch=JSketchSettings(enabled=True, k_max=K_MAX,
                                             proj_kind="psparse"))
    trun = RunConfig(**kw, optimizer=AdamWConfig(lr=1e-3),
                     sketch=SketchSettings(enabled=True, k_max=K_MAX,
                                           proj_kind="psparse"))
    jstate = jax_init_train_state(jax.random.PRNGKey(6), jcfg, jrun)
    state = _port_state(jstate, tcfg, trun)
    assert state.sketch.proj.num_tokens == Bp * Sp
    tok, lab = jax_lm_batch(jax.random.PRNGKey(7), Bp, Sp, jcfg.vocab_size)
    tb = {"tokens": torch.tensor(_np(tok), dtype=torch.int64),
          "labels": torch.tensor(_np(lab), dtype=torch.int64)}

    def loss_fn(params, sketch):
        out = jax_forward(params, tok, cfg=jcfg, mode="train",
                          sketch_state=sketch, settings=jrun.sketch)
        ce = jax_cross_entropy(out["logits"], lab, jrun.z_weight)
        return ce + jrun.aux_weight * out["aux"], out["sketch_state"]

    (jloss, jtree), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jstate.params, jstate.sketch)
    loss, _, _, grads, tree = make_train_step(tcfg, trun).loss_and_grads(
        state, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    want = interop.params_from_jax(_tree_np(jgrads))
    lay = FlatLayout(want)
    for gl, wl in zip(lay.unravel(lay.ravel(grads)).values(), want.values()):
        for g, w in zip(jax.tree.leaves(gl), jax.tree.leaves(wl)):
            torch.testing.assert_close(g, w, rtol=1e-4,
                                       atol=1e-5 * float(w.abs().max()))
    wtree = interop.tree_from_jax(_tree_np(jtree))
    assert tree.step == wtree.step == 1
    for name in ("ffn_in", "ffn_h"):
        for a in ("x", "y", "z"):
            w = getattr(wtree.nodes[name], a)
            torch.testing.assert_close(getattr(tree.nodes[name], a), w,
                                       rtol=1e-5,
                                       atol=1e-6 * float(w.abs().max()))


def test_forward_train_and_eval_logits_match_reference():
    jcfg, tcfg = _cfgs()
    from repro.models.transformer import init_params as jax_init_params
    jparams = jax_init_params(jax.random.PRNGKey(2), jcfg)
    params = interop.params_from_jax(_tree_np(jparams))
    jb, tb = _batch(3, jcfg.vocab_size)
    for mode in ("train", "eval"):
        want = _np(jax_forward(jparams, jb["tokens"], cfg=jcfg,
                               mode=mode)["logits"])
        got = forward(params, tb["tokens"], cfg=tcfg, mode=mode)["logits"]
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)
    ce = cross_entropy(torch.from_numpy(want), tb["labels"], 1e-4)
    np.testing.assert_allclose(float(ce), float(jax_cross_entropy(
        jnp.asarray(want), jb["labels"], 1e-4)), rtol=1e-6)


def test_adamw_on_the_lm_tree_matches_reference():
    jcfg, tcfg = _cfgs()
    from repro.models.transformer import init_params as jax_init_params
    from repro.optim.adamw import init_adamw as jax_init_adamw
    jparams = jax_init_params(jax.random.PRNGKey(4), jcfg)
    jgrads = jax.tree.map(lambda p: 0.3 * p + 0.01, jparams)
    jst = jax_init_adamw(jparams, JAdamWConfig(lr=1e-2))
    for _ in range(2):
        jnew, jst, jm = jax_adamw_update(jparams, jgrads, jst,
                                         JAdamWConfig(lr=1e-2), 0.5)
    params = interop.params_from_jax(_tree_np(jparams))
    from repro_torch.optim.adamw import init_adamw
    st = init_adamw(params, AdamWConfig(lr=1e-2))
    for _ in range(2):   # the update consumes its gradient tree
        grads = interop.params_from_jax(_tree_np(jgrads))
        new, st, m = adamw_update(params, grads, st, AdamWConfig(lr=1e-2),
                                  0.5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    want = interop.params_from_jax(_tree_np(jnew))
    lay = FlatLayout(want)
    np.testing.assert_allclose(lay.ravel(new).numpy(),
                               lay.ravel(want).numpy(), rtol=1e-6,
                               atol=1e-7)


def test_warmup_cosine_matches_reference():
    for s in range(0, 45, 3):
        assert warmup_cosine(s, warmup_steps=5, total_steps=40) == \
            pytest.approx(float(jax_warmup_cosine(
                jnp.int32(s), warmup_steps=5, total_steps=40)), abs=1e-7)


def test_lm_batch_has_the_references_structure():
    tok, lab = lm_batch(torch.Generator().manual_seed(0), 3, 20, 50)
    assert tok.shape == lab.shape == (3, 20) and int(tok.max()) < 50
    assert torch.equal(tok[:, 1:], lab[:, :-1])
    seq = torch.cat([tok, lab[:, -1:]], 1)
    motif = seq[:, ::3]                       # every third: the motif
    assert torch.equal(motif[:, 8:], motif[:, :motif.shape[1] - 8]) or \
        motif.shape[1] <= 8


def test_nan_guard_keeps_the_old_state_and_counts_a_skip():
    _, tcfg = _cfgs()
    _, trun = _runs("int8_p2")
    state = init_train_state(0, tcfg, trun, device="cpu")
    _, tb = _batch(0, tcfg.vocab_size)
    step = make_train_step(tcfg, trun)
    state, _ = step(state, tb)
    state.params["layers"][0]["mlp"]["w_down"][0, 0] = float("nan")
    before = FlatLayout(state.params).ravel(state.params).clone()
    u, v = state.opt["err"]["u"].clone(), state.opt["err"]["v"].clone()
    tree_y = state.sketch.nodes["ffn_h"].y.clone()
    new, m = step(state, tb)
    assert not np.isfinite(float(m["loss"]))
    assert new.skipped == m["skipped_total"] == 1 and new.step == 2
    torch.testing.assert_close(FlatLayout(new.params).ravel(new.params),
                               before, equal_nan=True, rtol=0, atol=0)
    assert torch.equal(new.opt["err"]["u"], u)
    assert torch.equal(new.opt["err"]["v"], v)
    assert int(new.opt["count"]) == 1
    assert torch.equal(new.sketch.nodes["ffn_h"].y, tree_y)
    assert new.sketch.step == state.sketch.step


@pytest.mark.parametrize("mode", ["none", "int8_p2"])
def test_train_step_leaves_no_tensor_in_a_reference_cycle(mode):
    """Every tensor a step drops is freed by its reference count: a
    tensor that only the garbage collector frees holds device memory
    (whole parameter trees at full width) until a collection runs."""
    import gc
    _, tcfg = _cfgs()
    _, trun = _runs(mode)
    state = init_train_state(0, tcfg, trun, device="cpu")
    step = make_train_step(tcfg, trun)
    gc.collect()
    was_enabled = gc.isenabled()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        for i in range(2):
            state, _ = step(state, _batch(i, tcfg.vocab_size)[1])
        gc.collect()
        cycled = [tuple(o.shape) for o in gc.garbage
                  if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        if was_enabled:
            gc.enable()
    assert not cycled, cycled


def test_checkpoint_round_trip(tmp_path):
    _, tcfg = _cfgs()
    _, trun = _runs("fp32")
    state = init_train_state(0, tcfg, trun, device="cpu")
    _, tb = _batch(0, tcfg.vocab_size)
    state, _ = make_train_step(tcfg, trun)(state, tb)
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        ck.save_async(s, state, metadata={"note": s})
    ck.wait()
    assert ck.latest_step() == 3 and sorted(p.name for p in tmp_path.iterdir()
                                            ) == ["step_0000000002",
                                                  "step_0000000003"]
    template = init_train_state(1, tcfg, trun, device="cpu")
    got, meta = ck.restore(template)
    assert meta["note"] == 3 and ck.metadata(2)["step"] == 2
    assert got.step == state.step == 1 and got.sketch.step == 1
    lay = FlatLayout(state.params)
    assert torch.equal(lay.ravel(got.params), lay.ravel(state.params))
    for a, b in ((got.opt["err"]["v"], state.opt["err"]["v"]),
                 (got.opt["count"], state.opt["count"]),
                 (got.sketch.nodes["ffn_in"].z, state.sketch.nodes["ffn_in"].z),
                 (got.monitor.buffer, state.monitor.buffer)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert got.monitor.count == state.monitor.count
    with pytest.raises(ValueError, match="another state structure"):
        ck.restore(init_train_state(0, tcfg, _runs("none")[1], device="cpu"))


def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    args = ["--reduced", "--device", "cpu", "--seq-len", "16", "--batch", "4",
            "--compress", "countsketch", "--cs-p2", "2", "--wire-dtype",
            "int8", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    state, hist = train_launcher.main(args + ["--steps", "3"])
    assert len(hist) == 3 and state.skipped == 0
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert "done: 3 steps" in capsys.readouterr().out
    state, hist = train_launcher.main(args + ["--steps", "5"])
    assert [h["step"] for h in hist] == [3, 4] and state.step == 5


def test_launcher_rerun_of_a_finished_run_takes_no_step(tmp_path, capsys):
    """The same command twice: the second restores the first's final
    checkpoint, takes no step and says so."""
    args = ["--reduced", "--device", "cpu", "--seq-len", "16", "--batch", "2",
            "--steps", "2", "--ckpt-dir", str(tmp_path)]
    first, hist = train_launcher.main(args)
    assert len(hist) == 2 and "done: 2 steps, final loss" in \
        capsys.readouterr().out
    again, hist = train_launcher.main(args)
    assert hist == [] and again.step == 2
    assert "done: 0 steps, resumed at step 2, skipped 0" in \
        capsys.readouterr().out
    assert torch.equal(first.params["embed"]["embedding"],
                       again.params["embed"]["embedding"])


def test_data_parallel_and_mesh_options_name_their_roadmap_item(monkeypatch):
    """Data parallelism over one worker axis is ported (test_torch_dp.py);
    the sharded merge and dp groups over several mesh axes raise naming
    ROADMAP A14, in RunConfig and in the launcher."""
    for kw in (dict(dp_merge="reduce_scatter", dp_axis_name="data",
                    dp_workers=2, dp_collective="overlap"),
               dict(dp_axis_name=("pod", "data"), dp_workers=2)):
        with pytest.raises(NotImplementedError, match="A14"):
            RunConfig(seq_len=8, global_batch=2, **kw)
    RunConfig(seq_len=8, global_batch=2, dp_axis_name="data", dp_workers=2,
              sketch_wire_dtype="int8", ring_wire=True)
    assert SketchSettings(dp_defer=True).dp_defer
    for flags in (["--dp-pods", "2"], ["--debug-mesh"], ["--multi-pod"],
                  ["--dp", "2", "--dp-merge", "reduce_scatter",
                   "--dp-collective", "overlap"]):
        argv = ["--reduced", "--device", "cpu"] + flags
        with pytest.raises(NotImplementedError, match="A14"):
            train_launcher.main(argv)
    with pytest.raises(SystemExit, match="invalid flag combination"):
        train_launcher.main(["--reduced", "--device", "cpu", "--ring-wire"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_launcher.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_train_state(0, _cfgs()[1], _runs("none")[1])


def test_init_draws_on_the_device_and_sizes_the_monitor():
    _, tcfg = _cfgs()
    _, trun = _runs("int8_p2")
    st = init_train_state(0, tcfg, trun, device="cpu")
    assert st.opt["err"]["u"].shape == (num_params(tcfg),)
    assert tuple(st.monitor.buffer.shape) == (32, 2 * tcfg.num_layers, 3)
    assert st.sketch.nodes["ffn_h"].x.shape == (tcfg.num_layers, 128, K_MAX)
    params = init_params(torch.Generator().manual_seed(0), tcfg)
    assert TS.flat_dim(params) == num_params(tcfg)


def test_loop_rewinds_after_nan_skips_and_adapts_the_rank(tmp_path,
                                                          monkeypatch):
    """A weight turned NaN before the third step: that step and the next
    are skipped, the second skip in a row rewinds to the checkpoint of
    step 2, and training goes on; meanwhile the adaptive controller,
    each step, shrinks the rank while the loss improves."""
    _, tcfg = _cfgs()
    run = RunConfig(**RUN_KW, sketch=SketchSettings(enabled=True,
                                                    k_max=K_MAX),
                    adaptive=AdaptiveConfig(r0=4, r_min=1, r_max=4,
                                            patience_decrease=1))
    calls = []
    make = loop_mod.make_train_step

    def poisoned(cfg, run):
        step = make(cfg, run)

        def wrapped(state, batch):
            calls.append(state.step)
            if len(calls) == 3:
                state.params["layers"][0]["mlp"]["w_down"][0, 0] = \
                    float("nan")
            return step(state, batch)
        return wrapped

    monkeypatch.setattr(loop_mod, "make_train_step", poisoned)
    state, hist = loop_mod.run_training(
        tcfg, run, loop_mod.LoopConfig(num_steps=6, ckpt_every=2,
                                       ckpt_dir=str(tmp_path), max_skips=2,
                                       steps_per_epoch=1), device="cpu")
    assert [h["step"] for h in hist] == [0, 1, 2, 4, 5]
    assert [h["skipped_total"] for h in hist] == [0, 0, 1, 0, 0]
    assert calls == [0, 1, 2, 3, 2, 3] and state.step == 4
    assert state.skipped == 0
    lay = FlatLayout(state.params)
    assert bool(torch.isfinite(lay.ravel(state.params)).all())
    assert int(state.sketch.rank) < 4 and state.sketch.epoch >= 1
    assert state.adaptive.num_changes == state.sketch.epoch
