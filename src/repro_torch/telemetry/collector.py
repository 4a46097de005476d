"""Host-side telemetry collection over the device ring buffer
(counterpart of ``repro.telemetry.collector``).

Steps write sketch metrics into ``core.monitor.MonitorState`` on the
device; the helpers here copy the small (window, L, 3) ring to the host
and resolve it into ``TelemetryRecord`` fields.

``span`` times a section on the host clock. CUDA work is asynchronous,
so the timer synchronises the devices of the tensors handed to it before
it reads the clock.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from repro_torch.core.monitor import METRIC_NAMES, MonitorState


def latest_reading(state: MonitorState) -> np.ndarray | None:
    """The most recently written (L, N_METRICS) row of the ring, or
    None for an empty buffer."""
    if state.count == 0:
        return None
    idx = (state.idx - 1) % state.buffer.shape[0]
    return state.buffer[idx].cpu().numpy()


def node_metrics(reading: np.ndarray | None, paths: list[str]) -> dict:
    """{node_path: {metric_name: float}} from one tree_metrics row — the
    schema's ``nodes`` field. Empty for an empty ring."""
    if reading is None:
        return {}
    if reading.shape[0] != len(paths):
        raise ValueError(
            f"reading has {reading.shape[0]} rows but {len(paths)} "
            f"node paths — ring and tree are out of sync")
    return {
        path: {name: float(reading[i, j])
               for j, name in enumerate(METRIC_NAMES)}
        for i, path in enumerate(paths)
    }


def flag_paths(flags: dict, paths: list[str]) -> dict:
    """Resolve boolean (L,) flag tensors to node paths — the schema's
    ``flags`` field. Only non-empty pathologies appear."""
    out = {}
    for name, mask in flags.items():
        mask = mask.cpu().numpy() if isinstance(mask, torch.Tensor) \
            else np.asarray(mask)
        hit = [paths[i] for i, f in enumerate(mask) if f]
        if hit:
            out[name] = hit
    return out


@contextlib.contextmanager
def span(spans: dict, name: str):
    """Scoped wall-clock timer accumulating into ``spans[name]``.

        with span(spans, "decode") as block:
            out = step(...)
            block(out)          # synchronise out's device before the clock

    ``block`` may be called any number of times (0 = enqueue-only
    timing); it returns its argument.
    """
    pending = []

    def block(x):
        pending.append(x)
        return x

    t0 = time.perf_counter()
    try:
        yield block
    finally:
        for dev in {x.device for x in pending
                    if isinstance(x, torch.Tensor) and x.is_cuda}:
            torch.cuda.synchronize(dev)
        spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0
