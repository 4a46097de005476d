"""The frontend archs in the port against the JAX package, on the CPU:
musicgen-large (the identity frontend over its audio tokens) and
internvl2-76b (patch embeddings spliced over the first positions).

Configs: their parameter counts against the reference's
``abstract_params`` (``test_torch_isolation.py`` holds every registered
config field for field, these two included).

internvl2 (``reduced``: 2 layers, d 64, GQA 4/2, 4 patch positions;
f32), from the reference's ``init_params(PRNGKey(0))`` through
``params_from_jax``:
  * the train-mode forward with patch embeddings at f <= S and at f > S
    (which leaves the embeddings as they are), logits within 1e-5 of
    max; the loss's embedding gradient within 1e-5 of max, and zero at
    the tokens that sit only at the overwritten positions, in both;
  * three train steps with patch embeddings in every batch, sketching
    off, Gaussian and psparse (k_max 9), from the reference's
    ``init_train_state``: losses and gradient norms rtol 1e-5, the
    parameters within 1e-5 of max. psparse runs at B 2 x S 128 from
    PRNGKey(6), the full-rank draw ROADMAP section C names (the others
    at B 2 x S 16 from PRNGKey(0));
  * (``test_torch_recurrent_dp.py`` holds a fused W 2 data-parallel
    run with patch embeddings, in its one reference subprocess.)

musicgen (``reduced``: 2 layers, d 64, GELU FFN, vocab 256): served by
both engines with the monitor, as ``test_torch_serve.py`` serves (2
prompts of 8 tokens, 5 decode steps, a refill, one more step): tokens
and flags exact, decode logits rtol 1e-4, atol 1e-4, and the port's
tokens the same with its monitor off; three Gaussian train steps,
losses and gradient norms rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.models import transformer as jtransformer
from repro.models.frontends import fake_patch_embeds as jax_fake_patch_embeds
from repro.serve import ServeEngine as JaxServeEngine
from repro.train.state import RunConfig as JRunConfig
from repro.train.state import init_train_state as jax_init_train_state
from repro.train.step import cross_entropy as jax_cross_entropy
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import get_arch, reduced
from repro_torch.interop import params_from_jax, proj_from_jax, tree_from_jax
from repro_torch.models import transformer
from repro_torch.models.frontends import fake_patch_embeds
from repro_torch.optim.flat import get_path, leaf_paths, tree_like
from repro_torch.serve import ServeEngine
from repro_torch.train.state import RunConfig, init_train_state
from repro_torch.train.step import cross_entropy, make_train_step

VLM, AUDIO = "internvl2-76b", "musicgen-large"
TOL = 1e-5
B, K_MAX, STEPS = 2, 9, 3
SEQ = {"off": 16, "gaussian": 16, "psparse": 128}
KEY = {"off": 0, "gaussian": 0, "psparse": 6}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the steps are many small ops, and the other
    xdist workers share the cores. Restored afterwards."""
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


def _cfgs(arch):
    return jax_reduced(jax_get_arch(arch)), reduced(get_arch(arch))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [AUDIO, VLM])
def test_parameter_counts_match_reference(arch):
    """The full-width parameter count from the config, against the
    reference's ``abstract_params`` (the configs themselves are held
    field for field, full and reduced, by
    ``test_torch_isolation.py::test_configs_match_reference``)."""
    full = get_arch(arch)
    want = sum(a.size for a in jax.tree.leaves(
        jtransformer.abstract_params(jax_get_arch(arch))))
    assert transformer.num_params(full) == want
    # musicgen 2.424 B; internvl2 0.856 B a layer, 2.10 B of embeddings
    if arch == AUDIO:
        assert want // 10**6 == 2424
    else:
        d, V = full.d_model, full.vocab_size
        embed = 2 * V * d
        assert round(embed / 1e7) == 210
        assert round((want - embed - d) / full.num_layers / 1e6) == 856


def test_fake_patch_embeds_shape_and_scale():
    gen = torch.Generator().manual_seed(0)
    pe = fake_patch_embeds(gen, 3, 256, 64)
    assert pe.shape == (3, 256, 64) and pe.dtype == torch.bfloat16
    assert 0.015 < float(pe.float().std()) < 0.025
    want = jax_fake_patch_embeds(jax.random.PRNGKey(0), 3, 256, 64)
    assert want.shape == pe.shape and want.dtype == jnp.bfloat16


# ---------------------------------------------------------------------------
# internvl2: the splice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [0, 2], ids=["f_le_S", "f_gt_S"])
def test_splice_forward_and_embedding_gradient_match_reference(extra):
    """f = num_frontend_tokens (4) patch positions at S 16, or f = S + 2
    (no splice). Tokens are distinct, so the tokens at the overwritten
    positions occur nowhere else: their embedding rows get no
    gradient."""
    jcfg, cfg = _cfgs(VLM)
    S = 16
    f = cfg.num_frontend_tokens if not extra else S + extra
    rng = np.random.default_rng(1)
    tokens = rng.permutation(cfg.vocab_size)[:B * S].reshape(B, S)
    labels = rng.integers(0, cfg.vocab_size, (B, S))
    pe = (rng.standard_normal((B, f, cfg.d_model)) * 0.02).astype(np.float32)
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)

    def jloss(p):
        out = jtransformer.forward(p, jnp.asarray(tokens, jnp.int32),
                                   cfg=jcfg, mode="train",
                                   patch_embeds=jnp.asarray(pe))
        return jax_cross_entropy(out["logits"],
                                 jnp.asarray(labels, jnp.int32)), out["logits"]

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    paths = leaf_paths(params)
    leaves = [get_path(params, p).requires_grad_(True) for p in paths]
    live = tree_like(params, leaves)
    out = transformer.forward(live, torch.from_numpy(tokens), cfg=cfg,
                              mode="train",
                              patch_embeds=torch.from_numpy(pe))
    loss = cross_entropy(out["logits"], torch.from_numpy(labels))
    grads = tree_like(params, torch.autograd.grad(loss, leaves))
    _close(out["logits"], jlogits, 0, TOL)
    gemb = grads["embed"]["embedding"]
    jemb = _np(params_from_jax(jax.tree.map(np.asarray, jgrads))["embed"][
        "embedding"])
    _close(gemb, jemb, 0, TOL)
    spliced = tokens[:, :f].reshape(-1) if f <= S else np.zeros(0, int)
    rest = tokens[:, f:].reshape(-1) if f <= S else tokens.reshape(-1)
    assert np.all(_np(gemb)[spliced] == 0) and np.all(jemb[spliced] == 0)
    assert np.all(np.abs(_np(gemb)[rest]).sum(1) > 0)
    if f > S:       # no splice: the same as no patch embeddings
        plain = transformer.forward(params, torch.from_numpy(tokens),
                                    cfg=cfg, mode="train")["logits"]
        assert torch.equal(plain, out["logits"].detach())


def _train_states(arch, proj):
    jcfg, cfg = _cfgs(arch)
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


def _train_and_compare(arch, proj, patch: bool):
    (jcfg, jrun, js), (cfg, run, ts) = _train_states(arch, proj)
    jstep = jax.jit(jax_make_train_step(jcfg, jrun))
    step = make_train_step(cfg, run)
    rng = np.random.default_rng(7)
    for _ in range(STEPS):
        tok = rng.integers(0, cfg.vocab_size, (B, run.seq_len + 1))
        jb = {"tokens": jnp.asarray(tok[:, :-1]),
              "labels": jnp.asarray(tok[:, 1:])}
        tb = {"tokens": torch.from_numpy(tok[:, :-1]),
              "labels": torch.from_numpy(tok[:, 1:])}
        if patch:
            pe = (rng.standard_normal((B, cfg.num_frontend_tokens,
                                       cfg.d_model)) * 0.02
                  ).astype(np.float32)
            jb["patch_embeds"] = jnp.asarray(pe)
            tb["patch_embeds"] = torch.from_numpy(pe)
        js, jm = jstep(js, jb)
        ts, tm = step(ts, tb)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL,
                                       err_msg=k)
        assert tm["skipped_total"] == 0
    want = params_from_jax(jax.tree.map(np.asarray, js.params))
    for p in leaf_paths(want):
        _close(get_path(ts.params, p), _np(get_path(want, p)), TOL, TOL)
    return ts


@pytest.mark.parametrize("proj", ["off", "gaussian", "psparse"])
def test_internvl2_train_steps_with_patch_embeds_match_reference(proj):
    _train_and_compare(VLM, proj, patch=True)


# ---------------------------------------------------------------------------
# musicgen: served and trained
# ---------------------------------------------------------------------------

SERVE_BATCH, PROMPT, MAX_CONTEXT, DECODE_STEPS = 2, 8, 32, 5


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


def test_musicgen_served_with_the_monitor_matches_reference():
    jcfg, cfg = _cfgs(AUDIO)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (SERVE_BATCH, PROMPT))
    refill_prompt = rng.integers(0, cfg.vocab_size, (PROMPT,))
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    jeng = JaxServeEngine(cfg=jcfg, params=jparams, max_context=MAX_CONTEXT,
                          monitor=True)
    j_toks, j_logits = _drive(jeng, jnp.asarray(prompts, jnp.int32),
                              jnp.asarray(refill_prompt, jnp.int32))
    tree0 = jax.tree.map(np.asarray, jeng._init_monitor(SERVE_BATCH).tree)
    proj = {n: proj_from_jax(jax.tree.map(np.asarray, jeng._proj_for(n)))
            for n in (SERVE_BATCH * PROMPT, PROMPT)}
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    toks = {}
    for monitor in (True, False):
        eng = ServeEngine(cfg=cfg, params=params, max_context=MAX_CONTEXT,
                          monitor=monitor, device="cpu", projections=proj,
                          initial_tree=tree_from_jax(tree0))
        toks[monitor], logits = _drive(eng, torch.from_numpy(prompts),
                                       torch.from_numpy(refill_prompt))
        if monitor:
            np.testing.assert_allclose(logits, j_logits, rtol=1e-4,
                                       atol=1e-4)
            assert eng.telemetry_record().flags == \
                jeng.telemetry_record().flags
    np.testing.assert_array_equal(toks[True], j_toks)
    np.testing.assert_array_equal(toks[False], j_toks)


def test_musicgen_train_steps_match_reference():
    ts = _train_and_compare(AUDIO, "gaussian", patch=False)
    assert sorted(ts.sketch.nodes) == ["ffn_h", "ffn_in"]
