"""The port's W = 4 data-parallel paper-MLP step against the reference's
``make_dp_step`` under shard_map, on the CPU, at the reference's own DP
test size (20 -> 28 x3 -> 4, tanh, 8 rows a worker, k_max 9 at rank 3,
beta 0.9, Adam lr 1e-3).

The reference runs in ONE subprocess with 4 forced host devices (the
test process keeps one device), as ``tests/test_distributed.py`` runs
it: for each layout and variant it draws the state from PRNGKey(0),
takes 3 steps on batches drawn from PRNGKey(1) folded with the step, and
writes every state and loss into one .npz. The port takes each step
from the reference's state before it, with its 4 workers in one process,
so a step's differences do not compound.

Tolerances (f32 on both sides, sums in other orders): losses rtol 1e-5;
sketch trees rtol 1e-5, atol 1e-6 * max|reference|; Adam moments rtol
1e-4, atol 1e-5 * max|reference|, test_torch_paper_trainer.py's
tolerance for sketched gradients (they come through a QR and a pinv,
which amplify rounding by the sketch's condition number); parameters
atol 1e-6 (the first step from zero
moments moves each weight by lr * sign(g): a tolerance this tight also
holds every gradient's sign). Between the port's two layouts the trees
and the loss are equal bit for bit, the parameters within 1e-6.
"""
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs.paper import MLPConfig
from repro_torch.core.sketch import SketchConfig
from repro_torch.interop import adamw_state_from_jax, mlp_params_from_jax
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.collectives import collective_trace
from repro_torch.sketches.node import SketchNode
from repro_torch.sketches.tree import NodeTree
from repro_torch.train import paper_trainer as PT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, TL, STEPS = 4, 8, 3
CFG_KW = dict(name="t", d_in=20, d_hidden=28, d_out=4, num_hidden_layers=3,
              activation="tanh", batch_size=TL, learning_rate=1e-3)
SCFG_KW = dict(rank=3, max_rank=4, beta=0.9, batch_size=TL)
# run name -> (variant, collective)
RUNS = {"sketched_per_node": ("sketched_fixed", "per_node"),
        "sketched_overlap": ("sketched_fixed", "overlap"),
        "monitor_overlap": ("monitor", "overlap")}

REF_CODE = """
    import json, sys
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.configs.paper import MLPConfig
    from repro.core.sketch import SketchConfig
    from repro.models.mlp import mlp_init
    from repro.optim.adamw import AdamWConfig, init_adamw
    from repro.train.paper_trainer import init_mlp_sketch, make_dp_step

    CFG_KW, SCFG_KW, RUNS, W, STEPS = json.loads(sys.argv[2])
    mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
    cfg, scfg = MLPConfig(**CFG_KW), SketchConfig(**SCFG_KW)
    opt_cfg = AdamWConfig(lr=cfg.learning_rate, b2=0.999)
    out = {}
    for name, (variant, collective) in RUNS.items():
        kp, ks = jax.random.split(jax.random.PRNGKey(0))
        params, sk = mlp_init(kp, cfg), init_mlp_sketch(ks, cfg, scfg,
                                                        variant)
        opt = init_adamw(params, opt_cfg)
        step = make_dp_step(cfg, scfg, variant, opt_cfg, mesh,
                            collective=collective)
        for n in ("upsilon", "omega", "phi"):
            out[f"{name}/proj/{n}"] = np.asarray(sk.proj[n])
        out[f"{name}/psi"] = np.asarray(sk.nodes["hidden"].psi)

        def dump(s):
            pre = f"{name}/state{s}/"
            for i, layer in enumerate(params):
                for k, v in layer.items():
                    out[f"{pre}params/{i}/{k}"] = np.asarray(v)
                    out[f"{pre}m/{i}/{k}"] = np.asarray(opt["m"][i][k])
                    out[f"{pre}v/{i}/{k}"] = np.asarray(opt["v"][i][k])
            out[pre + "count"] = np.asarray(opt["count"])
            for a in "xyz":
                out[f"{pre}{a}"] = np.asarray(getattr(sk.nodes["hidden"], a))

        dump(0)
        key = jax.random.PRNGKey(1)
        for s in range(STEPS):
            kx = jax.random.fold_in(key, s)
            x = jax.random.normal(kx, (W * cfg.batch_size, cfg.d_in))
            y = jax.random.randint(jax.random.fold_in(kx, 1),
                                   (W * cfg.batch_size,), 0, cfg.d_out)
            out[f"{name}/batch{s}/x"] = np.asarray(x)
            out[f"{name}/batch{s}/y"] = np.asarray(y)
            params, opt, sk, loss = step(params, opt, sk, x, y)
            out[f"{name}/loss{s}"] = np.asarray(loss)
            dump(s + 1)
    np.savez(sys.argv[1], **out)
    print("OK")
"""


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ref.npz")
        proc = subprocess.run(
            [sys.executable, "-c", textwrap.dedent(REF_CODE), path,
             json.dumps([CFG_KW, SCFG_KW, RUNS, W, STEPS])],
            capture_output=True, text=True, env=env, timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        with np.load(path) as z:
            return {k: z[k] for k in z.files}


def _layers(ref, pre):
    return [{k: ref[f"{pre}/{i}/{k}"] for k in ("bias", "w")}
            for i in range(CFG_KW["num_hidden_layers"] + 1)]


def _state(ref, name, s):
    """The port's (params, opt, tree) from the reference's after s steps."""
    pre = f"{name}/state{s}/"
    params = mlp_params_from_jax(_layers(ref, pre + "params"))
    opt = adamw_state_from_jax({"m": _layers(ref, pre + "m"),
                                "v": _layers(ref, pre + "v"),
                                "count": ref[pre + "count"]})
    node = SketchNode(*(torch.from_numpy(ref[pre + a].copy())
                        for a in "xyz"),
                      psi=torch.from_numpy(ref[name + "/psi"].copy()))
    tree = NodeTree(nodes={"hidden": node},
                    proj={n: torch.from_numpy(ref[f"{name}/proj/{n}"].copy())
                          for n in ("upsilon", "omega", "phi")},
                    rank=torch.tensor(SCFG_KW["rank"], dtype=torch.int32),
                    step=s)
    return params, opt, tree


def _batch(ref, name, s):
    return (torch.from_numpy(ref[f"{name}/batch{s}/x"].copy()),
            torch.from_numpy(ref[f"{name}/batch{s}/y"].copy()).long())


def _step(name, **kw):
    variant, collective = RUNS[name]
    return PT.make_dp_step(MLPConfig(**CFG_KW), SketchConfig(**SCFG_KW),
                           variant, AdamWConfig(lr=CFG_KW["learning_rate"],
                                                b2=0.999), W,
                           collective=collective, **kw)


def _of_max(a, frac):
    return frac * float(np.abs(np.asarray(a)).max())


@pytest.mark.parametrize("name", list(RUNS))
def test_dp_steps_match_the_reference(ref, name):
    step = _step(name)
    for s in range(STEPS):
        params, opt, tree, loss = step(*_state(ref, name, s),
                                       *_batch(ref, name, s))
        np.testing.assert_allclose(float(loss), ref[f"{name}/loss{s}"],
                                   rtol=1e-5)
        pre = f"{name}/state{s + 1}/"
        for a in "xyz":
            want = ref[pre + a]
            np.testing.assert_allclose(
                getattr(tree.nodes["hidden"], a).numpy(), want, rtol=1e-5,
                atol=_of_max(want, 1e-6), err_msg=f"{name} {s} {a}")
        for what, got in (("params", params), ("m", opt["m"]),
                          ("v", opt["v"])):
            for i, layer in enumerate(_layers(ref, pre + what)):
                for k, want in layer.items():
                    tol = (dict(rtol=0, atol=1e-6) if what == "params" else
                           dict(rtol=1e-4, atol=_of_max(want, 1e-5)))
                    np.testing.assert_allclose(
                        got[i][k].numpy(), want, **tol,
                        err_msg=f"{name} {s} {what} {i} {k}")
        assert int(opt["count"]) == int(ref[pre + "count"])
        assert tree.step == s + 1


@pytest.mark.parametrize("variant", ["sketched_fixed", "monitor"])
def test_layouts_are_bitwise_equal_in_trees_and_loss(ref, variant):
    """3 chained steps of each layout from one state: trees and losses
    equal bit for bit; the collectives as each layout issues them."""
    name = "sketched_per_node" if variant == "sketched_fixed" \
        else "monitor_overlap"
    runs = {}
    for collective in ("per_node", "overlap"):
        step = PT.make_dp_step(MLPConfig(**CFG_KW), SketchConfig(**SCFG_KW),
                               variant, AdamWConfig(lr=1e-3, b2=0.999), W,
                               collective=collective)
        params, opt, tree = _state(ref, name, 0)
        losses = []
        with collective_trace() as log:
            for s in range(STEPS):
                params, opt, tree, loss = step(params, opt, tree,
                                               *_batch(ref, name, s))
                losses.append(loss)
        runs[collective] = (params, opt, tree, losses, log)
    (pa, oa, ta, la, log_a), (pb, ob, tb, lb, log_b) = runs.values()
    for a in "xyz":
        assert torch.equal(getattr(ta.nodes["hidden"], a),
                           getattr(tb.nodes["hidden"], a))
    assert all(torch.equal(u, v) for u, v in zip(la, lb))
    for u, v in zip(pa + oa["m"], pb + ob["m"]):
        for k in u:
            torch.testing.assert_close(u[k], v[k], rtol=1e-6, atol=1e-6)
    layers = CFG_KW["num_hidden_layers"]
    assert [r["name"] for r in log_b] == ["overlap_sketch",
                                          "overlap_grad"] * STEPS
    assert len(log_a) == STEPS * (3 * layers + 1 + 2 * (layers + 1))


@pytest.mark.parametrize("variant", ["corange", "standard"])
def test_dp_step_refuses_variants_without_one(variant):
    with pytest.raises(ValueError, match="paper-kind variants"):
        PT.make_dp_step(MLPConfig(**CFG_KW), SketchConfig(**SCFG_KW),
                        variant, AdamWConfig(), W)
    with pytest.raises(ValueError, match="collective"):
        PT.make_dp_step(MLPConfig(**CFG_KW), SketchConfig(**SCFG_KW),
                        "monitor", AdamWConfig(), W, collective="fused")
