"""Builds a CUDA source of the port into a shared library and loads it.

``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so``
beside the package (the directory is git-ignored), at first use, from
the repository's sources alone. The hash covers the flags, the source
and every ``csrc`` header it includes (``#include "..."``, followed
through the headers), so an edited source or header is rebuilt.
Libraries are bound with ``ctypes``:
compiling against PyTorch's headers would take minutes per build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_NUM_SMS: dict[int, int] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(path, os.X_OK):
        raise RuntimeError(
            "nvcc not found: building the CUDA kernels needs the CUDA "
            "toolkit (nvcc on PATH or under /usr/local/cuda/bin)")
    return path


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the local headers it includes, each once,
    in the order they are first reached."""
    seen: list[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / inc.decode()
                 for inc in _INCLUDE.findall(path.read_bytes())]
    return seen


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def compile_cu(src: Path, out: Path) -> str:
    """Compile the CUDA source ``src`` into the library ``out`` with the
    package's flags. Returns nvcc's log (with ``-Xptxas -v``: registers,
    shared memory, spills); raises if the build fails."""
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}")
    return proc.stdout


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless it is built already. Returns
    nvcc's log, empty when nothing was compiled; raises if the build
    fails."""
    out = lib_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    log = compile_cu(CSRC / f"{name}.cu", tmp)
    os.replace(tmp, out)           # atomic: a reader never sees half
    return log


def load(name: str, bind) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed; ``bind(lib)``
    declares its functions' argument and return types once, on load."""
    if name not in _LIBS:
        build(name)
        lib = ctypes.CDLL(str(lib_path(name)))
        bind(lib)
        _LIBS[name] = lib
    return _LIBS[name]


def num_sms(device) -> int:
    """Streaming multiprocessors of a CUDA device (launch grids follow
    it)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _NUM_SMS:
        _NUM_SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _NUM_SMS[idx]
