"""The port's other paper experiments against the JAX reference, on the
CPU at small sizes: the sketched CIFAR conv stem (hw 8, B 4), the CIFAR
hybrid (32x32x3 images into a 1024 -> 48 x2 -> 4 tail, B 8), the PINN
(PINN_POISSON's 2 -> 50 x3 -> 1 on 64 + 32 points) and the §4.5 bounds.

Weights, trees and batches are made on the JAX side and carried over
(``repro_torch.interop``); other inputs are drawn with numpy.
Tolerances, f32 on both sides with sums in other orders:
  * im2col, the conv stem, mlp_forward, the bounds: rtol 1e-5, atol 1e-6
    * max|reference|;
  * 5 train steps of the conv stem and of the hybrid from an injected
    state: losses rtol 1e-5; parameters atol 5e-5 and sketches atol 1e-4
    * max|reference| (test_torch_paper_trainer.py's: Adam's m / sqrt(v)
    carries a gradient's relative rounding whole into a coordinate whose
    gradient is near zero);
  * the PINN's loss and gradients (second derivatives through the MLP):
    rtol 1e-5, atol 1e-5 * max|reference|.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper import CIFAR_CONV as JAX_CIFAR_CONV
from repro.configs.paper import MLPConfig as JaxMLPConfig
from repro.configs.paper import PINN_POISSON as JAX_PINN
from repro.core import bounds as JB
from repro.core.sketch import SketchConfig as JaxSketchConfig
from repro.data.synthetic import class_prototypes, image_batch
from repro.models import mlp as JM
from repro.models.frontends import fake_cifar_batch
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.optim.adamw import init_adamw as jax_init_adamw
from repro.sketches import ema_triple_update as jax_ema_update
from repro.train import paper_trainer as JT
from repro_torch.configs.paper import CIFAR_CONV, PINN_POISSON, MLPConfig
from repro_torch.core import bounds as PB
from repro_torch.core.sketch import SketchConfig
from repro_torch.data.synthetic import cifar_prototypes
from repro_torch.data.synthetic import fake_cifar_batch as torch_fake_cifar
from repro_torch.data.synthetic import image_batch as torch_image_batch
from repro_torch.data.synthetic import pinn_points
from repro_torch.interop import mlp_params_from_jax, tree_from_jax
from repro_torch.models import mlp as PM
from repro_torch.optim.adamw import AdamWConfig, init_adamw
from repro_torch.train import paper_trainer as PT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONV_KW = dict(hw=8, batch_size=4, learning_rate=3e-4)
CONV_SCFG = dict(rank=4, max_rank=9, beta=0.9, batch_size=4,
                 recon_mode="fast")
HYBRID_KW = dict(name="h", d_in=1024, d_hidden=48, d_out=4,
                 num_hidden_layers=2, activation="relu", batch_size=8,
                 learning_rate=1e-3)
HYBRID_SCFG = dict(rank=2, max_rank=4, beta=0.9, batch_size=8,
                   recon_mode="fast")
STEPS = 5
# psparse at density 0.5, seed 4: each implicit matrix has full rank over
# the 9 active columns both over all 256 rows and over stage 2's 64 real
# rows (at density 0.1 about 6 support rows fall among those 64, so stage
# 2's sketch would be rank deficient and its reconstruction follow
# rounding: ROADMAP §C's psparse question)
PSPARSE_SEED, PSPARSE_DENSITY = 4, 0.5


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, rtol, atol_rel):
    want = np.asarray(want)
    np.testing.assert_allclose(
        _np(got), want, rtol=rtol,
        atol=atol_rel * max(float(np.abs(want).max()), 1e-30))


def _torch_tree(tree):
    """A reference dict/list tree of arrays as torch tensors."""
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


# -- pieces ------------------------------------------------------------------


def test_im2col_matches_the_reference_and_the_conv():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 5)).astype(np.float32)
    got = PM.im2col(torch.from_numpy(img), 3, 3)
    np.testing.assert_array_equal(_np(got), np.asarray(JM.im2col(img, 3, 3)))
    conv = (got @ torch.from_numpy(w).reshape(-1, 5)).reshape(2, 8, 8, 5)
    want = PM.conv_same(torch.from_numpy(img), torch.from_numpy(w))
    _close(conv, want, 1e-5, 1e-6)
    ref = jax.lax.conv_general_dilated(img, w, (1, 1), "SAME",
                                       dimension_numbers=("NHWC", "HWIO",
                                                          "NHWC"))
    _close(want, ref, 1e-5, 1e-6)


def test_conv_stem_and_mlp_forward_match_the_reference():
    key = jax.random.PRNGKey(1)
    stem = jax.tree.map(np.asarray, JM.conv_stem_init(key))
    img = np.random.default_rng(1).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    _close(PM.conv_stem_apply(_torch_tree(stem), torch.from_numpy(img)),
           JM.conv_stem_apply(stem, img), 1e-5, 1e-6)
    cfg = JaxMLPConfig(**HYBRID_KW)
    params = jax.tree.map(np.asarray, JM.mlp_init(key, cfg))
    x = np.random.default_rng(2).standard_normal((8, 1024)).astype(np.float32)
    logits, acts = PM.mlp_forward(mlp_params_from_jax(params),
                                  torch.from_numpy(x), MLPConfig(**HYBRID_KW))
    jlogits, jacts = JM.mlp_forward(params, x, cfg)
    assert len(acts) == len(jacts) == 3
    for g, w in zip([logits] + acts, [jlogits] + jacts):
        _close(g, w, 1e-5, 1e-6)


def test_synthetic_images_and_collocation_points():
    gen = torch.Generator().manual_seed(0)
    protos = torch.randn((10, 8 * 8 * 3), generator=gen)
    img, y = torch_image_batch(gen, protos, 4, hw=8)
    assert img.shape == (4, 8, 8, 3) and y.shape == (4,)
    interior, boundary = pinn_points(gen, 64, 400)
    assert interior.shape == (64, 2) and boundary.shape == (400, 2)
    assert ((interior >= 0) & (interior < 1)).all()
    on_side = ((boundary == 0) | (boundary == 1)).any(-1)
    assert on_side.all()
    for coord in (0, 1):
        for v in (0.0, 1.0):
            assert (boundary[:, coord] == v).any()


def test_stand_in_cifar_batches_follow_the_references_law():
    """The conv family's stand-in batches: N(0, 1) image prototypes plus
    noise of std 0.5, as the reference's ``fake_cifar_batch`` (bits
    differ: the draws are torch's)."""
    cfg = dataclasses.replace(JAX_CIFAR_CONV, hw=8, batch_size=512)
    img, y = fake_cifar_batch(jax.random.PRNGKey(1), cfg)
    protos = jax.random.normal(jax.random.PRNGKey(7), (10, 8, 8, 3))
    ref_noise = float(jnp.std(img - protos[y]))
    gen = torch.Generator().manual_seed(1)
    ours = cifar_prototypes(gen, 10, 8, 3)
    assert ours.shape == (10, 8, 8, 3)
    assert abs(float(ours.std()) - float(jnp.std(protos))) < 0.05
    img, y = torch_fake_cifar(gen, ours, 512)
    assert img.shape == (512, 8, 8, 3) and y.shape == (512,)
    assert abs(float((img - ours[y]).std()) - ref_noise) < 0.01
    clean, y = torch_fake_cifar(gen, ours, 16, noise=0.0)
    assert torch.equal(clean, ours[y])


def test_bounds_match_the_reference():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((40, 24)).astype(np.float32)
    delta = rng.standard_normal((40, 12)).astype(np.float32)
    ta, td = torch.from_numpy(a), torch.from_numpy(delta)
    for r in (0, 3, 10):
        _close(PB.tail_energy(ta, r), JB.tail_energy(a, r), 1e-5, 1e-6)
        _close(PB.reconstruction_bound(ta, r), JB.reconstruction_bound(a, r),
               1e-5, 1e-6)
        _close(PB.gradient_bound(td, ta, r, 0.1),
               JB.gradient_bound(delta, a, r, 0.1), 1e-5, 1e-6)


# -- the sketched conv stem ---------------------------------------------------


CONV_RUNS = [("gaussian", "sketched_fixed", 0),
             ("psparse", "sketched_fixed", PSPARSE_SEED),
             ("gaussian", "standard", 0)]


@pytest.mark.parametrize("proj_kind,variant,seed", CONV_RUNS,
                         ids=[f"{p}-{v}" for p, v, _ in CONV_RUNS])
def test_conv_steps_match_the_reference(proj_kind, variant, seed):
    jcfg = dataclasses.replace(JAX_CIFAR_CONV, **CONV_KW)
    density = PSPARSE_DENSITY if proj_kind == "psparse" else 0.1
    jscfg = JaxSketchConfig(**CONV_SCFG, proj_kind=proj_kind,
                            proj_density=density)
    key = jax.random.PRNGKey(seed)
    kp, ks = jax.random.split(key)
    params = JT.conv_init(kp, jcfg)
    sk = JT.init_conv_sketch(ks, jcfg, jscfg)
    jopt_cfg = JaxAdamWConfig(lr=jcfg.learning_rate, b2=0.999)
    jopt = jax_init_adamw(params, jopt_cfg)
    jstep = JT.make_conv_step(jcfg, jscfg, variant, jopt_cfg)
    cfg = dataclasses.replace(CIFAR_CONV, **CONV_KW)
    scfg = SketchConfig(**CONV_SCFG, proj_kind=proj_kind,
                        proj_density=density)
    p_params = _torch_tree(jax.tree.map(np.asarray, params))
    p_sk = tree_from_jax(jax.tree.map(np.asarray, sk))
    opt_cfg = AdamWConfig(lr=cfg.learning_rate, b2=0.999)
    p_opt = init_adamw(p_params, opt_cfg)
    step = PT.make_conv_step(cfg, scfg, variant, opt_cfg)
    for s in range(STEPS):
        img, y = fake_cifar_batch(jax.random.fold_in(key, s), jcfg)
        params, jopt, sk, loss = jstep(params, jopt, sk, img, y)
        p_params, p_opt, p_sk, p_loss = step(
            p_params, p_opt, p_sk, torch.tensor(np.asarray(img)),
            torch.from_numpy(np.asarray(y)).long())
        _close(p_loss, loss, 1e-5, 0)
    for g, w in zip(_leaves(p_params), jax.tree.leaves(params)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=5e-5)
    assert p_sk.step == int(sk.step)
    for name in ("conv1", "conv2"):
        for a in "xyz":
            _close(getattr(p_sk.nodes[name], a), getattr(sk.nodes[name], a),
                   0, 1e-4)
    if variant != "standard":
        assert float(p_sk.nodes["conv2"].y.abs().max()) > 0


def test_conv_trainer_runs_and_counts_its_nodes():
    cfg = dataclasses.replace(CIFAR_CONV, **CONV_KW)
    scfg = SketchConfig(**CONV_SCFG)
    gen = torch.Generator().manual_seed(1)
    protos = torch.randn((cfg.d_out, 8 * 8 * 3), generator=gen)
    res = PT.train_conv(cfg, scfg, "sketched_fixed", steps=3,
                        batch_fn=lambda s: torch_image_batch(gen, protos, 4,
                                                             hw=8),
                        device="cpu")
    assert len(res.history) == 3 and res.sketch.step == 3
    assert res.monitor.count == 3 and res.monitor.buffer.shape[1] == 2
    assert all(np.isfinite(h["loss"]) for h in res.history)


# -- the CIFAR hybrid --------------------------------------------------------


def _bench_hybrid():
    spec = importlib.util.spec_from_file_location(
        "bench_cifar_hybrid", os.path.join(REPO, "benchmarks",
                                           "bench_cifar_hybrid.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hybrid_steps_match_the_reference():
    """The reference's ``bench_cifar_hybrid._make_step`` (joint regime):
    exact stem, sketched dense tail."""
    jcfg = JaxMLPConfig(**HYBRID_KW)
    jscfg = JaxSketchConfig(**HYBRID_SCFG)
    key = jax.random.PRNGKey(7)
    protos = class_prototypes(key, jcfg.d_out, 32 * 32 * 3)
    kp = jax.random.fold_in(key, 2)
    params = {"stem": JM.conv_stem_init(kp), "mlp": JM.mlp_init(kp, jcfg)}
    sk = JT.init_mlp_sketch(kp, jcfg, jscfg, "sketched_fixed")
    jopt_cfg = JaxAdamWConfig(lr=jcfg.learning_rate, b2=0.999)
    jopt = jax_init_adamw(params, jopt_cfg)
    jstep = _bench_hybrid()._make_step(jcfg, jscfg, "sketched_fixed",
                                       jopt_cfg)
    cfg, scfg = MLPConfig(**HYBRID_KW), SketchConfig(**HYBRID_SCFG)
    p_params = {"stem": _torch_tree(jax.tree.map(np.asarray,
                                                 params["stem"])),
                "mlp": mlp_params_from_jax(jax.tree.map(np.asarray,
                                                        params["mlp"]))}
    p_sk = tree_from_jax(jax.tree.map(np.asarray, sk))
    opt_cfg = AdamWConfig(lr=cfg.learning_rate, b2=0.999)
    p_opt = init_adamw(p_params, opt_cfg)
    step = PT.make_hybrid_step(cfg, scfg, "sketched_fixed", opt_cfg)
    for s in range(STEPS):
        img, y = image_batch(jax.random.fold_in(key, 100 + s), protos,
                             jcfg.batch_size, noise=1.0)
        params, jopt, sk, loss = jstep(params, jopt, sk, img, y)
        p_params, p_opt, p_sk, p_loss = step(
            p_params, p_opt, p_sk, torch.tensor(np.asarray(img)),
            torch.from_numpy(np.asarray(y)).long())
        _close(p_loss, loss, 1e-5, 0)
    for g, w in zip(_leaves(p_params), jax.tree.leaves(params)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=5e-5)
    for a in "xyz":
        _close(getattr(p_sk.nodes["hidden"], a),
               getattr(sk.nodes["hidden"], a), 0, 1e-4)


# -- the PINN -----------------------------------------------------------------


def _pinn_inputs():
    rng = np.random.default_rng(4)
    params = jax.tree.map(np.asarray, JM.mlp_init(jax.random.PRNGKey(0),
                                                  JAX_PINN))
    interior = rng.uniform(size=(64, 2)).astype(np.float32)
    boundary = rng.uniform(size=(32, 2)).astype(np.float32)
    boundary[:16, 0] = np.round(boundary[:16, 0])
    boundary[16:, 1] = np.round(boundary[16:, 1])
    return params, interior, boundary


def test_pinn_loss_and_gradients_match_the_reference():
    params, interior, boundary = _pinn_inputs()
    want, jgrads = jax.value_and_grad(JM.pinn_loss)(params, JAX_PINN,
                                                    interior, boundary)
    live = [{k: v.requires_grad_(True) for k, v in p.items()}
            for p in mlp_params_from_jax(params)]
    got = PM.pinn_loss(live, PINN_POISSON, torch.from_numpy(interior),
                       torch.from_numpy(boundary))
    _close(got, want, 1e-5, 0)
    grads = torch.autograd.grad(got, [p[k] for p in live for k in sorted(p)])
    for g, w in zip(grads, jax.tree.leaves(jgrads)):
        _close(g, w, 1e-5, 1e-5)
    xy = torch.from_numpy(interior)
    _close(PM.poisson_rhs(xy), JM.poisson_rhs(interior), 1e-6, 1e-7)


def test_pinn_monitor_steps_match_the_reference_and_leave_weights_alone():
    """Two steps of the monitored PINN (AdamW without clip, then the
    monitor's EMA update of each hidden node on the new weights'
    activations, as benchmarks/bench_pinn.py steps) against the same
    reference calls; the unmonitored run's weights are the same."""
    params, interior, boundary = _pinn_inputs()
    jcfg = dataclasses.replace(JAX_PINN, batch_size=64)
    cfg = dataclasses.replace(PINN_POISSON, batch_size=64)
    jscfg = JaxSketchConfig(rank=2, max_rank=8, beta=0.95, batch_size=64)
    scfg = SketchConfig(rank=2, max_rank=8, beta=0.95, batch_size=64)
    sk = JT.init_mlp_sketch(jax.random.PRNGKey(5), jcfg, jscfg, "monitor")
    p_sk = tree_from_jax(jax.tree.map(np.asarray, sk))
    jopt_cfg = JaxAdamWConfig(lr=JAX_PINN.learning_rate, b2=0.999,
                              grad_clip=0.0)
    opt_cfg = AdamWConfig(lr=PINN_POISSON.learning_rate, b2=0.999,
                          grad_clip=0.0)
    jp, jopt = params, jax_init_adamw(params, jopt_cfg)
    p = mlp_params_from_jax(params)
    p_off, p_opt, p_opt_off = p, init_adamw(p, opt_cfg), init_adamw(p, opt_cfg)
    step = PT.make_pinn_step(cfg, scfg, opt_cfg)
    ti, tb = torch.from_numpy(interior), torch.from_numpy(boundary)
    for _ in range(2):
        _, g = jax.value_and_grad(JM.pinn_loss)(jp, JAX_PINN, interior,
                                                boundary)
        jp, jopt, _ = jax_adamw_update(jp, g, jopt, jopt_cfg)
        _, acts = JM.mlp_forward(jp, interior, JAX_PINN)
        hidden = sk.nodes["hidden"]
        new = [jax_ema_update(hidden.x[l], hidden.y[l], hidden.z[l],
                              acts[l + 1][:64], sk.proj["upsilon"],
                              sk.proj["omega"], sk.proj["phi"],
                              hidden.psi[l], 0.95, sk.k_active)
               for l in range(3)]
        sk = dataclasses.replace(sk, nodes={"hidden": dataclasses.replace(
            hidden, **{a: jnp.stack([t[i] for t in new])
                       for i, a in enumerate("xyz")})})
        p, p_opt, p_sk, _ = step(p, p_opt, p_sk, ti, tb)
        p_off, p_opt_off, none, _ = step(p_off, p_opt_off, None, ti, tb)
        assert none is None
    for g, w, off in zip(_leaves(p), jax.tree.leaves(jp), _leaves(p_off)):
        _close(g, w, 1e-5, 1e-5)
        torch.testing.assert_close(g, off, rtol=0, atol=1e-6)
    for a in "xyz":
        _close(getattr(p_sk.nodes["hidden"], a),
               getattr(sk.nodes["hidden"], a), 0, 1e-4)
    assert p_sk.step == 2
    xy = torch.from_numpy(interior)
    pred = np.asarray(JM.mlp_forward(jp, interior, JAX_PINN)[0])[:, 0]
    exact = np.asarray(JM.poisson_exact(interior))
    want = np.linalg.norm(pred - exact) / np.linalg.norm(exact)
    np.testing.assert_allclose(PT.l2_rel_error(p, PINN_POISSON, xy), want,
                               rtol=1e-5)
    assert 0 < PT.l2_rel_error(p, PINN_POISSON, n=256) < 10


def test_pool2_matches_the_reference():
    """The stem's 2x2 max-pool (``F.max_pool2d`` with NHWC around it)
    against the reference's reduce_window, on an odd width."""
    x = np.random.default_rng(5).standard_normal((2, 4, 7, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(_np(PM.pool2(torch.from_numpy(x))),
                                  np.asarray(JT._pool2(x)))
