"""Sketch-native telemetry: one schema for train and serve, shared with
the JAX package (counterpart of ``repro.telemetry``)."""
from repro_torch.telemetry.schema import (
    RECORD_KINDS, SCHEMA_VERSION, TelemetryRecord, record_from_json,
    record_to_json, record_to_line, run_metadata,
)
from repro_torch.telemetry.log import TelemetryLog, read_jsonl
from repro_torch.telemetry.collector import (
    flag_paths, latest_reading, node_metrics, span,
)

__all__ = [
    "RECORD_KINDS", "SCHEMA_VERSION", "TelemetryLog", "TelemetryRecord",
    "flag_paths", "latest_reading", "node_metrics", "read_jsonl",
    "record_from_json", "record_to_json", "record_to_line", "run_metadata",
    "span",
]
