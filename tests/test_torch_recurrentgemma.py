"""recurrentgemma-2b served and trained in the port against the JAX
package, on the CPU.

The model: reduced recurrentgemma-2b cut to 5 layers (one (rglru, rglru,
local) period, then the (rglru, rglru) tail, as the full model's 26
layers end), d 64, lru 64, 4 query heads on one KV head, window 32; the
reference's weights carried over by ``params_from_jax``.

Serving: both engines monitored, from the JAX engine's projections and
initial tree, prefill 2 prompts of 24 tokens, decode 16 steps (the local
layers' 32-slot rings wrap at position 32), refill slot 1 with a
36-token prompt (longer than the window: the prefill places the last 32
keys in the ring) and decode once more. Tokens and flags exact, decode
logits rtol 1e-4, atol 1e-4, the "res" sketches and every cache entry
rtol 1e-4, atol 1e-5 * max|reference|, as the dense archs' serving test
holds them.

Training: the reduced config as ``reduced`` cuts it (3 layers: one
period; each layer's reference compile costs seconds), three steps with
sketching off, Gaussian and psparse projections (k_max 9: the FFN
nodes' sketched backprop and the "rglru_h" carry node), from the
reference's ``init_train_state(PRNGKey(0))``, at B 2 x S 16. psparse
runs at B 2 x S 128 from PRNGKey(6), as ``test_torch_lm_train.py``'s
psparse step: the reference's multiply-shift signs are rank-deficient
for most draws (ROADMAP section C; none of keys 0-39 gives full rank at
S 16, 32 or 64), and a rank-deficient sketch leaves the sketched FFN's
reconstruction to rounding, where the two packages' gradients part by
their own size (seen at key 0); key 6 at 256 tokens has full rank in all
three. Losses and gradient norms rtol 1e-5; parameters and the
"ffn_in", "ffn_h" and "rglru_h" triples within 1e-5 * max|reference|.

The local layers' attention at the full model's head_dim 256 and MQA
(10 query heads on one KV head): the plain versions against the
reference's oracle ``flash_attention_ref`` and jax.vjp of it, rtol and
atol 1e-5 * max (f32); and the dk/dv pass's geometry there (64 keys a
block, the query heads split until the SMs hold two blocks each).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.models import transformer as jtransformer
from repro.kernels.ref import flash_attention_ref
from repro.models.transformer import init_params as jax_init_params
from repro.serve import ServeEngine as JaxServeEngine
from repro.train.state import RunConfig as JRunConfig
from repro.train.state import init_train_state as jax_init_train_state
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import get_arch, reduced
from repro_torch.interop import params_from_jax, proj_from_jax, tree_from_jax
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import transformer
from repro_torch.serve import ServeEngine
from repro_torch.train.state import RunConfig, init_train_state
from repro_torch.train.step import make_train_step

ARCH = "recurrentgemma-2b"
LAYERS = 5
TOL = 1e-5
BATCH, PROMPT, REFILL, MAX_CONTEXT, DECODE_STEPS = 2, 24, 36, 48, 16
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


def _cfgs():
    return (dataclasses.replace(jax_reduced(jax_get_arch(ARCH)),
                                num_layers=LAYERS),
            dataclasses.replace(reduced(get_arch(ARCH)), num_layers=LAYERS))


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


@pytest.fixture(scope="module")
def served():
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(0)
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


def test_served_tokens_logits_and_flags_match_reference(served):
    np.testing.assert_array_equal(served[True]["toks"], served["j_toks"])
    np.testing.assert_array_equal(served[False]["toks"], served["j_toks"])
    np.testing.assert_allclose(served[True]["logits"], served["j_logits"],
                               rtol=1e-4, atol=1e-4)
    assert served[True]["eng"].telemetry_record().flags == \
        served["j_rec"].flags


def test_served_sketches_and_caches_match_reference(served):
    """The monitor's "res" triples, and every cache entry of every slot
    (the RG-LRU state and conv tail, the local layers' rings), the
    refilled slot's too."""
    jeng, eng = served["jeng"], served[True]["eng"]
    jtree, tree = jeng._slots["mon"].tree, eng._slots["mon"].tree
    assert tree.step == int(jtree.step) == DECODE_STEPS + 3
    for f in ("x", "y", "z"):
        _close(getattr(tree.nodes["res"], f), getattr(jtree.nodes["res"], f),
               rtol=1e-4, atol_rel=1e-5)
    jc = jeng._slots["cache"]
    P, G = len(jeng.cfg.pattern), jeng.cfg.num_groups
    kinds = []
    for layer, one in enumerate(eng._slots["cache"]):
        want = (jc["groups"][layer % P] if layer < G * P
                else jc["tail"][layer - G * P])
        kinds.append(sorted(one))
        for name, t in one.items():
            w = np.asarray(want[name])
            _close(t, w[layer // P] if layer < G * P else w, rtol=1e-4,
                   atol_rel=1e-5)
    assert kinds == [["conv", "r_h"]] * 2 + [["k", "v"]] + \
        [["conv", "r_h"]] * 2


# ---------------------------------------------------------------------------
# training, against the reference's step
# ---------------------------------------------------------------------------


def _states(proj):
    jcfg, cfg = jax_reduced(jax_get_arch(ARCH)), reduced(get_arch(ARCH))
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


@pytest.mark.parametrize("proj", ["off", "gaussian", "psparse"])
def test_train_steps_match_reference(proj):
    (jcfg, jrun, js), (cfg, run, ts) = _states(proj)
    jstep = jax.jit(jax_make_train_step(jcfg, jrun))
    step = make_train_step(cfg, run)
    rng = np.random.default_rng(7)
    for _ in range(STEPS):
        tok = rng.integers(0, cfg.vocab_size, (B, run.seq_len + 1))
        js, jm = jstep(js, {"tokens": jnp.asarray(tok[:, :-1]),
                            "labels": jnp.asarray(tok[:, 1:])})
        ts, tm = step(ts, {"tokens": torch.from_numpy(tok[:, :-1]),
                           "labels": torch.from_numpy(tok[:, 1:])})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=TOL)
        assert tm["skipped_total"] == 0
    flat_g = dict(_leaves(ts.params))
    for path, w in _leaves(params_from_jax(jax.tree.map(np.asarray,
                                                        js.params))):
        _close(flat_g[path], _np(w), rtol=TOL, atol_rel=TOL)
    if proj == "off":
        assert ts.sketch is None and js.sketch is None
        return
    assert sorted(ts.sketch.nodes) == sorted(js.sketch.nodes) == \
        ["ffn_h", "ffn_in", "rglru_h"]
    # one rglru_h entry an RG-LRU layer, in layer order
    assert transformer.node_layers("rglru_h", cfg) == [0, 1]
    assert transformer.node_layers("rglru_h", _cfgs()[1]) == [0, 1, 3, 4]
    for name, node in js.sketch.nodes.items():
        for a in "xyz":
            _close(getattr(ts.sketch.nodes[name], a), getattr(node, a),
                   rtol=TOL, atol_rel=TOL)
    assert ts.sketch.step == int(js.sketch.step)


# ---------------------------------------------------------------------------
# the local layers' attention at head_dim 256
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 40])
def test_flash_plain_versions_at_head_dim_256_match_oracle(window):
    rng = np.random.default_rng(256)
    q, do = (rng.standard_normal((1, 10, 70, 256)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, 1, 70, 256)).astype(np.float32)
            for _ in range(2))

    def ref(a, b, c):
        return flash_attention_ref(a, b, c, causal=True, window=window)

    want_o, grads = jax.jit(lambda a, b, c, g: (lambda o, vjp: (o, vjp(g)))(
        *jax.vjp(ref, a, b, c)))(q, k, v, do)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = FA.flash_attention_plain(tq, tk, tv, window=window)
    _close(o, want_o, rtol=TOL, atol_rel=TOL)
    got = FA.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, window=window)
    for g, w in zip(got, grads):
        _close(g, w, rtol=TOL, atol_rel=TOL)


@pytest.mark.parametrize("B,S,want", [
    (4, 512, 9),        # the train step: 8 key blocks a (b, KV head)
    (1, 4096, 5),       # the window-crossing step: 64
    (8, 2048, 2),       # 256 blocks unsplit, short of 264
])
def test_dkdv_pass_fills_the_sms_at_head_dim_256(B, S, want):
    cfg = get_arch(ARCH)
    keys = FA.dkdv_keys(cfg.head_dim, torch.bfloat16)
    assert keys == 64 and FA.dkdv_keys(128, torch.bfloat16) == 128
    splits = FA.dkdv_splits(B, cfg.num_kv_heads, S,
                            cfg.num_heads // cfg.num_kv_heads, 132, keys)
    assert splits == want
    assert -(-S // keys) * B * splits >= 2 * 132


def test_chunked_cross_entropy_equals_the_whole_tensor_form():
    """The trainer's loss widens its logits to f32 CE_ROWS rows at a time
    (a 256,000-word vocabulary at 4,096 tokens would keep 4.2 GB of f32
    logits); its loss and gradient equal autograd's through the
    whole-tensor form bit for bit, across chunks, with and without the
    z-loss, from bf16 and f32 logits."""
    from repro_torch.train.step import CE_ROWS, cross_entropy

    def whole(lg, labels, z):
        lg = lg.float()
        lse = torch.logsumexp(lg, dim=-1)
        ce = (lse - lg.gather(-1, labels[..., None])[..., 0]).mean()
        return ce + z * (lse ** 2).mean() if z > 0 else ce

    gen = torch.Generator().manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        for z in (0.0, 1e-4):
            x = (3 * torch.randn((3, CE_ROWS // 2 + 7, 50),
                                 generator=gen)).to(dtype)
            labels = torch.randint(0, 50, x.shape[:-1], generator=gen)
            a, b = (x.clone().requires_grad_(True) for _ in range(2))
            want, got = whole(a, labels, z), cross_entropy(b, labels, z)
            assert torch.equal(got, want)
            assert torch.equal(torch.autograd.grad(got, b)[0],
                               torch.autograd.grad(want, a)[0])
