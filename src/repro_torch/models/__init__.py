"""Dense-attention decoder models (counterpart of ``repro.models``)."""
