"""Edited copies of the port's CUDA sources, built and loaded in place of
the package's libraries: the mutant and variant tools share this.

``build`` copies ``csrc/<kernel>.cu`` and the local headers it includes
into a directory of its own, applies the edits, and compiles it there
with the package's flags (the checkout is not touched); ``loaded`` puts
the library in place of the package's for a ``with`` block, so that the
kernel's wrapper launches it.
"""
from __future__ import annotations

import contextlib
import ctypes
from pathlib import Path

from repro_torch.kernels import _build


def edit(text: str, old: str, new: str, nth: int = 0) -> str:
    """``text`` with the ``nth`` occurrence (from 0) of ``old`` replaced
    by ``new``; raises ValueError if there is no such occurrence."""
    at = -1
    for _ in range(nth + 1):
        at = text.find(old, at + 1)
        if at < 0:
            raise ValueError(f"the text to edit moved: {old!r}")
    return text[:at] + new + text[at + len(old):]


def build(kernel: str, out: Path, edits=(), tag: str | None = None) -> Path:
    """``csrc/<kernel>.cu`` and its headers copied into ``out / tag``
    (``tag`` defaults to the kernel) with ``edits`` applied, each a
    (file name, old text, new text) or (..., occurrence) tuple, and
    built there. Returns the library's path."""
    where = out / (tag or kernel)
    where.mkdir(parents=True)
    texts = {path.name: path.read_text() for path in _build.sources(kernel)}
    for name, old, new, *nth in edits:
        texts[name] = edit(texts[name], old, new, *nth)
    for name, text in texts.items():
        (where / name).write_text(text)
    lib = where / f"lib{kernel}.so"
    _build.compile_cu(where / f"{kernel}.cu", lib)
    return lib


@contextlib.contextmanager
def loaded(kernel: str, lib_file: Path, bind):
    """The library ``lib_file``, bound by ``bind``, in place of the
    package's ``kernel`` library inside the block."""
    lib = ctypes.CDLL(str(lib_file))
    bind(lib)
    _build._LIBS[kernel] = lib
    try:
        yield lib
    finally:
        _build._LIBS.pop(kernel, None)
