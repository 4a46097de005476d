"""Serving: slot-batched prefill/decode engine with live activation
monitoring (counterpart of ``repro.serve``)."""
from repro_torch.serve.engine import (
    ServeEngine, ServeMonitorState, decode_step, detect_slot_pathologies,
    prefill_step, refill_step,
)

__all__ = [
    "ServeEngine", "ServeMonitorState", "decode_step",
    "detect_slot_pathologies", "prefill_step", "refill_step",
]
