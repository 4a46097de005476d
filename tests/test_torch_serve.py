"""The port's monitored serving path against the JAX reference engine.

Both engines get the same weights (``params_from_jax``), the same
monitor projections and initial sketch tree (the JAX engine's), and the
same prompts, drawn with numpy. The JAX engine runs its default jnp
sketch update (the same formula as the kernel); the port runs on the
CPU, where ``sketch_update`` takes its plain version. Each engine
prefills, decodes 5 steps, refills slot 1 and decodes once more.

Configs: reduced tinyllama-1.1b, and reduced gemma3-27b cut to 8 layers
(one scanned group of 6 plus a 2-layer tail in the reference, tied
embeddings) with window 8, so its 12-token prompts overflow the local
layers' ring caches at prefill and the ring wraps while decoding. The
"tinyllama-psparse" case monitors through seeds-only p-sparsified
projections (``monitor_proj_kind="psparse"``): the JAX engine takes its
gather path, the port ``psparse_update``'s plain version.

Tolerances: tokens and flags exact; decode logits rtol 1e-4, atol 1e-4;
sketches and the metrics ring rtol 1e-4, atol 1e-5 * max|reference|
(f32 on both sides, sums taken in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init_params
from repro.serve import ServeEngine as JaxServeEngine
from repro.telemetry import read_jsonl as jax_read_jsonl
from repro_torch.configs import get_arch, reduced
from repro_torch.interop import params_from_jax, proj_from_jax, tree_from_jax
from repro_torch.models.transformer import forward
from repro_torch.serve import ServeEngine
from repro_torch.telemetry import TelemetryLog

CASES = {
    "tinyllama": dict(arch="tinyllama-1.1b", cut={}, prompt_len=8),
    "gemma3": dict(arch="gemma3-27b", cut=dict(num_layers=8, window_size=8),
                   prompt_len=12),
    "tinyllama-psparse": dict(arch="tinyllama-1.1b", cut={}, prompt_len=8,
                              proj_kind="psparse"),
}
BATCH = 2
MAX_CONTEXT = 32
DECODE_STEPS = 5          # 6 new tokens with the prefill's
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
SKETCH_RTOL = 1e-4
SKETCH_ATOL_REL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _drive(eng, prompts, refill_prompt):
    """Tokens after every step, and the logits of every decode step."""
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


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request, tmp_path_factory):
    case = CASES[request.param]
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(case["arch"])),
                               **case["cut"])
    cfg = dataclasses.replace(reduced(get_arch(case["arch"])), **case["cut"])
    S0 = case["prompt_len"]
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (BATCH, S0))
    refill_prompt = rng.integers(0, cfg.vocab_size, (S0,))

    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    proj_kind = case.get("proj_kind", "gaussian")
    jeng = JaxServeEngine(cfg=jcfg, params=jparams, max_context=MAX_CONTEXT,
                          monitor=True, monitor_proj_kind=proj_kind)
    j_toks, j_logits = _drive(jeng, jnp.asarray(prompts, jnp.int32),
                              jnp.asarray(refill_prompt, jnp.int32))

    # the JAX engine's monitor RNG state, fed to the port
    tree0 = jax.tree.map(np.asarray, jeng._init_monitor(BATCH).tree)
    proj = {n: proj_from_jax(jax.tree.map(np.asarray, jeng._proj_for(n)))
            for n in (BATCH * S0, S0)}
    params = params_from_jax(jax.tree.map(np.asarray, jparams))

    def port(monitor):
        eng = ServeEngine(cfg=cfg, params=params, max_context=MAX_CONTEXT,
                          monitor=monitor, device="cpu", projections=proj,
                          initial_tree=tree_from_jax(tree0),
                          monitor_proj_kind=proj_kind)
        toks, logits = _drive(eng, torch.from_numpy(prompts),
                              torch.from_numpy(refill_prompt))
        return eng, toks, logits

    eng, toks, logits = port(True)
    _, toks_off, _ = port(False)
    log_path = tmp_path_factory.mktemp("telemetry") / "serve.jsonl"
    with TelemetryLog(str(log_path)) as log:
        log.append(eng.telemetry_record())
    return dict(jeng=jeng, j_rec=jeng.telemetry_record(), j_toks=j_toks,
                j_logits=j_logits, eng=eng, toks=toks, logits=logits,
                toks_off=toks_off, log_path=log_path)


def test_tokens_match_reference(run):
    np.testing.assert_array_equal(run["toks"], run["j_toks"])


def test_decode_logits_match_reference(run):
    np.testing.assert_allclose(run["logits"], run["j_logits"], **LOGIT_TOL)


def _close(got, want):
    want = np.asarray(want)
    atol = SKETCH_ATOL_REL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got), want, rtol=SKETCH_RTOL, atol=atol)


def test_sketches_match_reference(run):
    jtree = run["jeng"]._slots["mon"].tree
    tree = run["eng"]._slots["mon"].tree
    assert tree.step == int(jtree.step) == DECODE_STEPS + 3
    for f in ("x", "y", "z", "psi"):
        _close(getattr(tree.nodes["res"], f), getattr(jtree.nodes["res"], f))


def test_monitor_ring_matches_reference(run):
    jmon = run["jeng"]._slots["mon"]
    mon = run["eng"]._slots["mon"]
    assert (mon.ring.idx, mon.ring.count) == \
        (int(jmon.ring.idx), int(jmon.ring.count))
    _close(mon.ring.buffer, jmon.ring.buffer)
    _close(mon.slot_ema, jmon.slot_ema)
    np.testing.assert_array_equal(_np(mon.slot_steps), jmon.slot_steps)


def test_flags_match_reference(run):
    assert run["eng"].telemetry_record().flags == run["j_rec"].flags


def test_monitor_does_not_change_tokens(run):
    np.testing.assert_array_equal(run["toks"], run["toks_off"])


def test_telemetry_reads_back_through_reference_reader(run):
    """One schema: the port's JSONL parses with the JAX package's reader
    into the fields the JAX engine emits."""
    header, recs = jax_read_jsonl(str(run["log_path"]))
    assert header["telemetry_header"] == 1 and header["backend"] == "cpu"
    (rec,) = recs
    want = run["j_rec"]
    assert (rec.kind, rec.step) == (want.kind, want.step)
    assert set(rec.scalars) == set(want.scalars)
    assert set(rec.spans) == set(want.spans)
    assert rec.flags == want.flags
    assert list(rec.nodes) == list(want.nodes)
    for path, mets in want.nodes.items():
        for name, v in mets.items():
            np.testing.assert_allclose(rec.nodes[path][name], v,
                                       rtol=SKETCH_RTOL, atol=1e-6)


def test_eval_forward_matches_reference_across_groups():
    """params_from_jax maps layer g*P+i of the reference's stacked groups
    (here G=2 groups of P=6, plus a 1-layer tail) to port layer g*P+i:
    the full-sequence logits agree only if every layer lands in place."""
    cut = dict(num_layers=13, window_size=8)
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch("gemma3-27b")), **cut)
    cfg = dataclasses.replace(reduced(get_arch("gemma3-27b")), **cut)
    assert (jcfg.num_groups, len(jcfg.pattern), len(jcfg.tail_types)) == \
        (2, 6, 1)
    jparams = jax_init_params(jax.random.PRNGKey(3), jcfg)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12))
    want = jax.jit(lambda p, t: jax_forward(p, t, cfg=jcfg, mode="eval"))(
        jparams, jnp.asarray(tokens, jnp.int32))["logits"]
    got = forward(params_from_jax(jax.tree.map(np.asarray, jparams)),
                  torch.from_numpy(tokens), cfg=cfg, mode="eval")["logits"]
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)
