"""qwen3-moe-30b-a3b and mixtral-8x22b served and trained in the port
against the JAX package, on the CPU.

The models: reduced qwen3-moe-30b-a3b (2 layers, d 64, 4 query heads on
2 KV heads, 4 experts top-2 at d_ff 128) and reduced mixtral-8x22b (the
same with 32-token sliding-window attention), the reference's weights
carried over by ``params_from_jax``.

Serving: both engines monitored, from the JAX engine's projections and
initial tree, prefill 2 prompts of 24 tokens (48 tokens: capacity 32 a
expert), decode 12 steps (capacity 4 at 2 tokens), refill slot 1 with a
20-token prompt and decode once more; mixtral's decode runs past its
window. Tokens and flags exact, decode logits rtol 1e-4, atol 1e-4, the
"res" sketches rtol 1e-4, atol 1e-5 * max|reference|, as the dense
archs' serving test holds them; the unmonitored engine's tokens equal.

Training: three steps each with sketching off, Gaussian and psparse
projections (k_max 9: "attn_o" sketched backprop on the attention
out-projection, the monitoring-only "expert_in" stacks) from the
reference's ``init_train_state``, at B 2 x S 16 (psparse at B 2 x S 128
from PRNGKey(6): the reference's hashes are rank-deficient for most
draws, ROADMAP section C). Losses, the load-balance loss and gradient
norms rtol 1e-5; parameters and the triples within 1e-5 *
max|reference|. mixtral: one Gaussian step. Then the launchers on
reduced qwen3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.models import transformer as jtransformer
from repro.models.transformer import init_params as jax_init_params
from repro.serve import ServeEngine as JaxServeEngine
from repro.train.state import RunConfig as JRunConfig
from repro.train.state import init_train_state as jax_init_train_state
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_arch, reduced
from repro_torch.interop import params_from_jax, proj_from_jax, tree_from_jax
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import transformer
from repro_torch.serve import ServeEngine
from repro_torch.train.state import RunConfig, init_train_state
from repro_torch.train.step import make_train_step

QWEN, MIXTRAL = "qwen3-moe-30b-a3b", "mixtral-8x22b"
TOL = 1e-5
BATCH, PROMPT, REFILL, MAX_CONTEXT, DECODE_STEPS = 2, 24, 20, 48, 12
B, K_MAX, STEPS = 2, 9, 3
SEQ = {"off": 16, "gaussian": 16, "psparse": 128}
KEY = {"off": 0, "gaussian": 0, "psparse": 6}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(got, want, rtol, atol_rel):
    want = np.asarray(want)
    atol = atol_rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# serving, against the reference engine
# ---------------------------------------------------------------------------


def _drive(eng, prompts, refill_prompt):
    toks = [_np(eng.start(prompts))]
    logits = []
    for _ in range(DECODE_STEPS):
        toks.append(_np(eng.decode_step()))
        logits.append(_np(eng.last_logits))
    eng.refill(1, refill_prompt)
    toks.append(_np(eng._slots["tok"]))
    toks.append(_np(eng.decode_step()))
    logits.append(_np(eng.last_logits))
    return np.stack(toks), np.stack(logits)


def _serve(arch):
    jcfg, cfg = jax_reduced(jax_get_arch(arch)), reduced(get_arch(arch))
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT))
    refill_prompt = rng.integers(0, cfg.vocab_size, (REFILL,))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    jeng = JaxServeEngine(cfg=jcfg, params=jparams, max_context=MAX_CONTEXT,
                          monitor=True)
    j_toks, j_logits = _drive(jeng, jnp.asarray(prompts, jnp.int32),
                              jnp.asarray(refill_prompt, jnp.int32))
    tree0 = jax.tree.map(np.asarray, jeng._init_monitor(BATCH).tree)
    proj = {n: proj_from_jax(jax.tree.map(np.asarray, jeng._proj_for(n)))
            for n in (BATCH * PROMPT, REFILL)}
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    out = dict(jeng=jeng, j_rec=jeng.telemetry_record(), j_toks=j_toks,
               j_logits=j_logits)
    for monitor in (True, False):
        eng = ServeEngine(cfg=cfg, params=params, max_context=MAX_CONTEXT,
                          monitor=monitor, device="cpu", projections=proj,
                          initial_tree=tree_from_jax(tree0))
        toks, logits = _drive(eng, torch.from_numpy(prompts),
                              torch.from_numpy(refill_prompt))
        out[monitor] = dict(eng=eng, toks=toks, logits=logits)
    return out


@pytest.fixture(scope="module", params=[QWEN, MIXTRAL])
def served(request):
    return _serve(request.param)


def test_served_tokens_logits_and_flags_match_reference(served):
    np.testing.assert_array_equal(served[True]["toks"], served["j_toks"])
    np.testing.assert_array_equal(served[False]["toks"], served["j_toks"])
    np.testing.assert_allclose(served[True]["logits"], served["j_logits"],
                               rtol=1e-4, atol=1e-4)
    assert served[True]["eng"].telemetry_record().flags == \
        served["j_rec"].flags


def test_served_sketches_match_reference(served):
    jtree = served["jeng"]._slots["mon"].tree
    tree = served[True]["eng"]._slots["mon"].tree
    assert tree.step == int(jtree.step) == DECODE_STEPS + 3
    for f in ("x", "y", "z"):
        _close(getattr(tree.nodes["res"], f), getattr(jtree.nodes["res"], f),
               rtol=1e-4, atol_rel=1e-5)


# ---------------------------------------------------------------------------
# training, against the reference's step
# ---------------------------------------------------------------------------


def _states(arch, proj):
    jcfg, cfg = jax_reduced(jax_get_arch(arch)), reduced(get_arch(arch))
    kw = dict(enabled=proj != "off", k_max=K_MAX, beta=0.9,
              recon_mode="fast",
              proj_kind=proj if proj != "off" else "gaussian")
    common = dict(seq_len=SEQ[proj], global_batch=B, warmup_steps=2,
                  total_steps=40)
    jrun = JRunConfig(**common, sketch=jtransformer.SketchSettings(**kw))
    run = RunConfig(**common, sketch=transformer.SketchSettings(**kw))
    js = jax_init_train_state(jax.random.PRNGKey(KEY[proj]), jcfg, jrun)
    tree = (tree_from_jax(jax.tree.map(np.asarray, js.sketch))
            if js.sketch is not None else None)
    ts = init_train_state(0, cfg, run, device="cpu", sketch=tree,
                          params=params_from_jax(
                              jax.tree.map(np.asarray, js.params)))
    return (jcfg, jrun, js), (cfg, run, ts)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch,proj,steps", [
    (QWEN, "off", STEPS), (QWEN, "gaussian", STEPS), (QWEN, "psparse", STEPS),
    (MIXTRAL, "gaussian", 1)])
def test_train_steps_match_reference(arch, proj, steps):
    (jcfg, jrun, js), (cfg, run, ts) = _states(arch, proj)
    jstep = jax.jit(jax_make_train_step(jcfg, jrun))
    step = make_train_step(cfg, run)
    rng = np.random.default_rng(7)
    for _ in range(steps):
        tok = rng.integers(0, cfg.vocab_size, (B, run.seq_len + 1))
        js, jm = jstep(js, {"tokens": jnp.asarray(tok[:, :-1]),
                            "labels": jnp.asarray(tok[:, 1:])})
        ts, tm = step(ts, {"tokens": torch.from_numpy(tok[:, :-1]),
                           "labels": torch.from_numpy(tok[:, 1:])})
        for m in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(float(tm[m]), float(jm[m]), rtol=TOL)
        assert float(tm["aux"]) > 0 and tm["skipped_total"] == 0
    flat = dict(_leaves(ts.params))
    for path, w in _leaves(params_from_jax(jax.tree.map(np.asarray,
                                                        js.params))):
        _close(flat[path], _np(w), rtol=TOL, atol_rel=TOL)
    if proj == "off":
        assert ts.sketch is None and js.sketch is None
        return
    assert sorted(ts.sketch.nodes) == sorted(js.sketch.nodes) == \
        ["attn_o", "expert_in"]
    assert ts.sketch.nodes["expert_in"].x.shape == (2, 4, 64, K_MAX)
    for name, node in js.sketch.nodes.items():
        for a in "xyz":
            _close(getattr(ts.sketch.nodes[name], a), getattr(node, a),
                   rtol=TOL, atol_rel=TOL)
    assert ts.sketch.step == int(js.sketch.step)
    assert ts.monitor.buffer.shape[1] == 2 + 2 * 4


def test_moe_state_checkpoints_and_restores(tmp_path):
    """The (L, E, d, k) stacks, psi and the experts' weights round-trip
    through the checkpointer."""
    _, (cfg, run, ts) = _states(QWEN, "gaussian")
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(1, ts)
    back, _ = ck.restore(ts, 1)
    for name in ("attn_o", "expert_in"):
        for a in "xyz":
            assert torch.equal(getattr(back.sketch.nodes[name], a),
                               getattr(ts.sketch.nodes[name], a))
    assert torch.equal(back.sketch.nodes["expert_in"].psi,
                       ts.sketch.nodes["expert_in"].psi)
    assert torch.equal(back.params["layers"][1]["moe"]["we_down"],
                       ts.params["layers"][1]["moe"]["we_down"])


def test_num_params_and_leaves_count_the_experts():
    cfg = get_arch(QWEN)
    # 48 layers of 623.1 M (604.0 M experts, 18.9 M attention, 0.26 M
    # router) beside 622.3 M of embedding and head
    assert transformer.num_params(cfg) == 30_532_110_336
    small = reduced(cfg)
    gen = torch.Generator().manual_seed(0)
    params = transformer.init_params(gen, small)
    n = sum(t.numel() for _, t in _leaves(params))
    assert n == transformer.num_params(small)
    assert len(transformer.reference_leaves(params, small)) == \
        transformer.num_reference_leaves(small) == 3 + 1 + 4 + 5


def test_launchers_serve_and_train_reduced_qwen3(tmp_path, capsys):
    out = serve_launcher.main(["--arch", QWEN, "--reduced", "--device",
                               "cpu", "--monitor", "--num-prompts", "2",
                               "--prompt-len", "8", "--max-new", "4",
                               "--max-context", "16"])
    assert tuple(out.shape) == (2, 4)
    assert "pathology flags" in capsys.readouterr().out
    state, hist = train_launcher.main([
        "--arch", QWEN, "--reduced", "--device", "cpu", "--batch", "2",
        "--seq-len", "16", "--steps", "2", "--ckpt-every", "2",
        "--ckpt-dir", str(tmp_path)])
    assert len(hist) == 2 and state.skipped == 0
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert sorted(state.sketch.nodes) == ["attn_o", "expert_in"]
