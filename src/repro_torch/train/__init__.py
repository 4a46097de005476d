"""Training loops (counterpart of ``repro.train``)."""
