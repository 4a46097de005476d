"""The PyTorch port stands alone: it loads without JAX, no source line of
it imports ``jax`` or the JAX package, its configs match the
reference's, and its entry points run on CUDA unless asked otherwise."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import paper as jax_paper
from repro.configs import reduced as jax_reduced
from repro_torch.configs import ARCHS, get_arch, paper, reduced
from repro_torch.launch import paper as paper_launcher
from repro_torch.launch import serve as serve_launcher
from repro_torch.train import paper_trainer
from repro_torch.serve import ServeEngine

SRC = Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"


def test_port_loads_without_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.interop, repro_torch.launch.serve\n"
        "import repro_torch.serve.engine, repro_torch.kernels.sketch_update\n"
        "import repro_torch.kernels.psparse_update, repro_torch.launch.paper\n"
        "import repro_torch.train.paper_trainer, repro_torch.sketches.linear\n"
        "import repro_torch.core.reconstruct, repro_torch.core.adaptive\n"
        "import repro_torch.optim.adamw, repro_torch.data.synthetic\n"
        "import repro_torch.models.frontends\n"
        "import repro_torch.countsketch, repro_torch.kernels.csvec_insert\n"
        "import repro_torch.kernels.csvec_topk, repro_torch.kernels.csvec_quant\n"
        "import repro_torch.optim.compression, repro_torch.optim.sketched_sgd\n"
        "import repro_torch.optim.schedule, repro_torch.data.pipeline\n"
        "import repro_torch.train.state, repro_torch.train.step\n"
        "import repro_torch.train.loop, repro_torch.launch.train\n"
        "import repro_torch.checkpoint.checkpointer\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.models.ssm, repro_torch.kernels.mlstm_chunk\n"
        "import repro_torch.kernels.ring_allreduce, repro_torch.parallel\n"
        "import repro_torch.parallel.collectives, repro_torch.sketches.wire\n"
        "import repro_torch.core.corange, repro_torch.core.bounds\n"
        "import repro_torch.models.mlp, repro_torch.sketches.psparse\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m == 'repro' or m.startswith('repro.')\n"
        "               for m in sys.modules), 'repro was imported'\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_source_line_imports_jax_or_the_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax\b|repro\b(?!_torch))")
    hits = [f"{p.relative_to(SRC)}:{i}"
            for p in sorted(PORT.rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits, hits


def test_engine_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_arch("tinyllama-1.1b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg=cfg, params={}, max_context=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_launcher.main(["--reduced"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paper_launcher.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paper_trainer.train(paper.MNIST_MLP, paper.MNIST_MLP.sketch,
                            "standard", steps=1, batch_fn=None)


def _same_fields(ours, ref):
    ref_fields = dataclasses.asdict(ref)
    for f, v in dataclasses.asdict(ours).items():
        if f == "dtype":
            assert str(v).split(".")[-1] == ref_fields[f].__name__, f
        elif isinstance(v, dict):
            _same_fields(getattr(ours, f), getattr(ref, f))
        else:
            assert v == ref_fields[f], f
    assert set(dataclasses.asdict(ours)) == set(ref_fields)


@pytest.mark.parametrize("name", ["MNIST_MLP", "CIFAR_HYBRID", "CIFAR_CONV",
                                  "PINN_POISSON", "MONITOR_HEALTHY",
                                  "MONITOR_PROBLEMATIC"])
def test_paper_configs_match_reference(name):
    _same_fields(getattr(paper, name), getattr(jax_paper, name))
    assert paper.PAPER_CONFIGS[getattr(paper, name).name] is \
        getattr(paper, name)


def test_paper_launcher_trains_on_cpu(capsys):
    res = paper_launcher.main(["--device", "cpu", "--steps", "4",
                               "--log-every", "2", "--variant",
                               "sketched_fixed", "--proj-kind", "psparse"])
    assert len(res.history) == 4 and res.sketch.step == 4
    out = capsys.readouterr().out
    assert "test acc" in out and "pathology flags" in out


@pytest.mark.parametrize("argv,says", [
    (["--config", "mnist_mlp", "--variant", "corange"], "test acc"),
    (["--config", "cifar_hybrid"], "test acc"),
    (["--config", "cifar_conv", "--proj-kind", "psparse"], "pathology"),
    (["--config", "pinn_poisson", "--variant", "monitor"],
     "L2 relative error")])
def test_paper_launcher_runs_every_experiment_on_cpu(argv, says, capsys):
    res = paper_launcher.main(["--device", "cpu", "--steps", "2",
                               "--log-every", "1"] + argv)
    assert len(res.history) == 2
    assert says in capsys.readouterr().out


@pytest.mark.parametrize("name", ARCHS)
def test_configs_match_reference(name):
    for ours, ref in ((get_arch(name), jax_get_arch(name)),
                      (reduced(get_arch(name)), jax_reduced(jax_get_arch(name)))):
        ref_fields = dataclasses.asdict(ref)
        for f, v in dataclasses.asdict(ours).items():
            if f in ("dtype", "param_dtype"):
                assert str(v).split(".")[-1] == ref_fields[f].__name__
            else:
                assert v == ref_fields[f], f
        assert ours.layer_types == ref.layer_types
        assert ours.tail_types == ref.tail_types


@pytest.mark.parametrize("name", ["musicgen-large", "internvl2-76b"])
def test_frontend_archs_are_ported(name):
    """Both frontend archs are registered with the reference's frontend
    and build parameters at reduced size."""
    from repro_torch.models.transformer import init_params, num_params
    from repro_torch.optim.sketched_sgd import flat_dim

    assert name in ARCHS
    ref = jax_get_arch(name)
    ours = get_arch(name)
    assert (ours.frontend, ours.num_frontend_tokens) == (
        ref.frontend, ref.num_frontend_tokens)
    small = reduced(ours)
    params = init_params(torch.Generator().manual_seed(0), small)
    assert flat_dim(params) == num_params(small)


@pytest.mark.parametrize("name", ["mixtral-8x22b", "qwen3-moe-30b-a3b"])
def test_moe_archs_are_ported(name):
    assert name in ARCHS and get_arch(name).is_moe
    assert get_arch(name) == dataclasses.replace(
        get_arch(name), num_experts=jax_get_arch(name).num_experts)


def test_launcher_serves_reduced_model_on_cpu(tmp_path, capsys):
    path = tmp_path / "serve.jsonl"
    out = serve_launcher.main(["--reduced", "--device", "cpu", "--monitor",
                               "--num-prompts", "2", "--prompt-len", "8",
                               "--max-new", "4", "--max-context", "16",
                               "--telemetry-json", str(path)])
    assert tuple(out.shape) == (2, 4)
    assert "pathology flags" in capsys.readouterr().out
    assert len(path.read_text().splitlines()) == 2   # header + record
