"""The one telemetry schema for train AND serve (counterpart of
``repro.telemetry.schema``, same ``SCHEMA_VERSION`` and JSON layout).

A run is a JSONL stream: one header object (``run_metadata``: git sha,
torch and CUDA versions, device, UTC timestamp) followed by one
``TelemetryRecord`` per emission. Records written by this package and
by the JAX package parse with either package's reader.

For records built from finite floats,
``record_from_json(record_to_json(r)) == r`` exactly: Python's json
emits float repr, which round-trips IEEE doubles.
"""
from __future__ import annotations

import dataclasses
import json
import platform
import subprocess
import sys
from datetime import datetime, timezone

SCHEMA_VERSION = 1
RECORD_KINDS = ("train", "serve")


@dataclasses.dataclass(frozen=True)
class TelemetryRecord:
    """One telemetry emission — a training step or a serving window."""

    kind: str                                  # "train" | "serve"
    step: int                                  # step / decode counter
    scalars: dict = dataclasses.field(default_factory=dict)
    # {node_path: {metric_name: value}} in sketches.node_paths order
    nodes: dict = dataclasses.field(default_factory=dict)
    # {pathology_name: [flagged node paths / slot ids]}
    flags: dict = dataclasses.field(default_factory=dict)
    # {span_name: seconds} — host wall-clock, device-synchronised
    spans: dict = dataclasses.field(default_factory=dict)
    # data-parallel accounting, filled by the JAX package's training
    # runs (0 / {} for serving)
    wire_bytes: int = 0                        # DP bytes/step/worker
    collectives: int = 0                       # DP collectives/step
    # {mesh_axis: size} of the run's device mesh ({} single-program)
    mesh: dict = dataclasses.field(default_factory=dict)
    # {axis_label: collectives/step} — reduce-scatter / all-reduce /
    # all-gather tallied into the axis they cross ("pod+data" labels
    # the flattened dp supergroup)
    per_axis_collectives: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in RECORD_KINDS:
            raise ValueError(
                f"TelemetryRecord.kind must be one of {RECORD_KINDS}, "
                f"got {self.kind!r}")


def record_to_json(rec: TelemetryRecord) -> dict:
    """Plain-dict form of a record (stable key set, schema-tagged)."""
    return {
        "schema": SCHEMA_VERSION,
        "kind": rec.kind,
        "step": rec.step,
        "scalars": dict(rec.scalars),
        "nodes": {p: dict(m) for p, m in rec.nodes.items()},
        "flags": {n: list(v) for n, v in rec.flags.items()},
        "spans": dict(rec.spans),
        "wire_bytes": rec.wire_bytes,
        "collectives": rec.collectives,
        "mesh": dict(rec.mesh),
        "per_axis_collectives": dict(rec.per_axis_collectives),
    }


def record_from_json(obj: dict) -> TelemetryRecord:
    """Inverse of ``record_to_json``; rejects unknown schema versions."""
    schema = obj.get("schema")
    if schema != SCHEMA_VERSION:
        raise ValueError(
            f"telemetry record schema {schema!r} != {SCHEMA_VERSION} "
            f"(this reader)")
    return TelemetryRecord(
        kind=obj["kind"],
        step=obj["step"],
        scalars=dict(obj.get("scalars", {})),
        nodes={p: dict(m) for p, m in obj.get("nodes", {}).items()},
        flags={n: list(v) for n, v in obj.get("flags", {}).items()},
        spans=dict(obj.get("spans", {})),
        wire_bytes=obj.get("wire_bytes", 0),
        collectives=obj.get("collectives", 0),
        mesh=dict(obj.get("mesh", {})),
        per_axis_collectives=dict(obj.get("per_axis_collectives", {})),
    )


def record_to_line(rec: TelemetryRecord) -> str:
    """One JSONL line (sorted keys so diffs of logs are stable)."""
    return json.dumps(record_to_json(rec), sort_keys=True)


def run_metadata(device=None) -> dict:
    """Attribution header for telemetry logs: enough to pin a metric
    trajectory to a commit, the PyTorch/CUDA versions and the device
    (``device`` defaults to the CUDA device when there is one)."""
    import torch

    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True,
            text=True, timeout=10).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        sha = "unknown"
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    on_cuda = device.type == "cuda"
    return {
        "git_sha": sha,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": device.type,
        "device_kind": (torch.cuda.get_device_name(device) if on_cuda
                        else "cpu"),
        "num_devices": torch.cuda.device_count() if on_cuda else 1,
        "python": sys.version.split()[0],
        "os": platform.platform(),
        "timestamp_utc": datetime.now(timezone.utc).isoformat(),
    }
