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
from repro.configs import reduced as jax_reduced
from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.launch import serve as serve_launcher
from repro_torch.serve import ServeEngine

SRC = Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"


def test_port_loads_without_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.interop, repro_torch.launch.serve\n"
        "import repro_torch.serve.engine, repro_torch.kernels.sketch_update\n"
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


@pytest.mark.parametrize("name", ["mixtral-8x22b", "xlstm-1.3b",
                                  "recurrentgemma-2b"])
def test_unported_archs_name_their_roadmap_item(name):
    jax_get_arch(name)                  # exists in the reference
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        get_arch(name)


def test_launcher_serves_reduced_model_on_cpu(tmp_path, capsys):
    path = tmp_path / "serve.jsonl"
    out = serve_launcher.main(["--reduced", "--device", "cpu", "--monitor",
                               "--num-prompts", "2", "--prompt-len", "8",
                               "--max-new", "4", "--max-context", "16",
                               "--telemetry-json", str(path)])
    assert tuple(out.shape) == (2, 4)
    assert "pathology flags" in capsys.readouterr().out
    assert len(path.read_text().splitlines()) == 2   # header + record
