"""Sketch-based monitoring (counterpart of ``repro.core``)."""
