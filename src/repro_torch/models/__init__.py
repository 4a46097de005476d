"""Models (counterpart of ``repro.models``): dense-attention decoders
and the paper MLPs."""
