"""Sketch configuration, reconstruction, adaptive rank and monitoring
(counterpart of ``repro.core``)."""
