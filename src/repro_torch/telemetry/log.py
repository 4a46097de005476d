"""JSONL telemetry exporter (counterpart of ``repro.telemetry.log``).

``TelemetryLog`` appends one header line (``run_metadata``) then one
line per ``TelemetryRecord``; ``read_jsonl`` parses a file written by
either package.
"""
from __future__ import annotations

import json
import os
from typing import IO

from repro_torch.telemetry.schema import (
    SCHEMA_VERSION, TelemetryRecord, record_from_json, record_to_line,
    run_metadata,
)


class TelemetryLog:
    """Append-only JSONL sink for one run's telemetry stream.

    The header line ({"telemetry_header": 1, ...run_metadata}) is
    written lazily on first append, so constructing a log costs no IO.
    Use as a context manager or call ``close``.
    """

    def __init__(self, path: str, meta: dict | None = None):
        self.path = path
        self.meta = meta
        self.records_written = 0
        self._fh: IO[str] | None = None

    def _ensure_open(self):
        if self._fh is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "w")
            header = {"telemetry_header": SCHEMA_VERSION,
                      **(self.meta if self.meta is not None
                         else run_metadata())}
            self._fh.write(json.dumps(header, sort_keys=True) + "\n")

    def append(self, rec: TelemetryRecord) -> None:
        self._ensure_open()
        self._fh.write(record_to_line(rec) + "\n")
        self.records_written += 1

    def flush(self):
        if self._fh is not None:
            self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_jsonl(path: str) -> tuple[dict, list[TelemetryRecord]]:
    """Parse one telemetry JSONL file -> (header, records)."""
    header: dict = {}
    records: list[TelemetryRecord] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if "telemetry_header" in obj:
                header = obj
            else:
                records.append(record_from_json(obj))
    return header, records
