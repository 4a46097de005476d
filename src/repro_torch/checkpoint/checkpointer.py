"""Atomic checkpointing of a single-device train state (counterpart of
``repro.checkpoint.checkpointer``).

Guarantees:
  * atomicity — a save writes a temporary directory, fsyncs, and
    publishes it with ``os.replace``, so a crash mid-save never corrupts
    the latest checkpoint;
  * keep-N — only the newest ``keep`` step directories stay;
  * async — ``save_async`` copies the state to the host at once and
    writes it on a thread, so the next step can start.

A state is any nesting of dataclasses, dicts, lists and tuples. Its
leaves are tensors and Python numbers; they are saved as numpy arrays
(bf16 as f32) in walk order, and ``restore`` puts them back into the
structure, dtypes and devices of a template state. Anything else (None,
strings, devices) is taken from the template; a leaf keeps the saved
shape. The data-parallel state holds its per-worker ledgers stacked on a
leading (W, ...) axis, the reference's ``per_worker_v1`` layout as its
``gather_per_worker`` makes it, so no gather or scatter is needed;
``train.loop`` writes the layout's metadata and splits the ledgers on a
restart at another worker count. The pre-NodeTree checkpoint migration
(``sketches/compat.py``) is out of scope (ROADMAP A14).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

_NUMBERS = (bool, int, float)
# the metadata value of checkpoints whose per-worker ledgers are stacked
# (W, ...) by worker
RESIDUAL_LAYOUT = "per_worker_v1"


def _walk(obj, path: str = ""):
    """(path, leaf) of every tensor and number of ``obj``, in order."""
    if isinstance(obj, torch.Tensor) or isinstance(obj, _NUMBERS):
        yield path, obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            if f.init:
                yield from _walk(getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, dict):
        for k in sorted(obj):
            yield from _walk(obj[k], f"{path}/{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _walk(v, f"{path}[{i}]")


def _host(leaf) -> np.ndarray:
    """A host copy of a leaf: a copy even of a CPU tensor, whose numpy
    view an async save would otherwise read after the caller changed
    it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _rebuild(template, leaves):
    """``template`` with each leaf replaced by the next of ``leaves``."""
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(next(leaves))).to(
            device=template.device, dtype=template.dtype)
    if isinstance(template, _NUMBERS):
        return type(template)(next(leaves).item())
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template) if f.init})
    if isinstance(template, dict):
        out = {k: _rebuild(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves) for v in template)
    return template


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def _steps(self) -> list[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                      if d.startswith("step_") and d[5:].isdigit())

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    # -- save ---------------------------------------------------------

    def _to_host(self, state):
        pairs = list(_walk(state))
        return [p for p, _ in pairs], [_host(x) for _, x in pairs]

    def save(self, step: int, state, metadata: dict | None = None):
        self.wait()
        paths, host = self._to_host(state)
        self._write(step, host, paths, metadata or {})

    def save_async(self, step: int, state, metadata: dict | None = None):
        self.wait()                       # one in-flight save at a time
        paths, host = self._to_host(state)   # device -> host copy now
        self._thread = threading.Thread(
            target=self._write, args=(step, host, paths, metadata or {}))
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_leaves, paths, metadata: dict):
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
        meta = dict(metadata)
        meta.update({"step": step, "time": time.time(),
                     "num_leaves": len(host_leaves), "paths": paths})
        with open(os.path.join(tmp, "metadata.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            # a re-save of an existing step: replace it through a
            # second rename
            stale = final + ".old"
            os.replace(final, stale)
            os.replace(tmp, final)
            shutil.rmtree(stale, ignore_errors=True)
        else:
            os.replace(tmp, final)        # atomic publish
        self._gc()

    def _gc(self):
        for s in self._steps()[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ------------------------------------------------------

    def metadata(self, step: int | None = None) -> dict:
        """The metadata of a checkpoint, without loading its arrays."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        with open(os.path.join(self._step_dir(step), "metadata.json")) as f:
            return json.load(f)

    def restore(self, template, step: int | None = None):
        """(state, metadata): the checkpoint's leaves in the structure,
        dtypes and devices of ``template``."""
        meta = self.metadata(step)
        paths = [p for p, _ in _walk(template)]
        if paths != meta["paths"]:
            raise ValueError(
                f"checkpoint at step {meta['step']} holds another state "
                f"structure ({meta['num_leaves']} leaves, the template "
                f"{len(paths)})")
        with np.load(os.path.join(self._step_dir(meta["step"]),
                                  "arrays.npz")) as z:
            leaves = [z[f"leaf_{i}"] for i in range(meta["num_leaves"])]
        return _rebuild(template, iter(leaves)), meta
