"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (taken for CPU tensors) and a launch counter:

    sketch_update   fused EMA X/Y/Z update, one pass over A
                    (replaces src/repro/kernels/sketch_update.py)
"""
from repro_torch.kernels.sketch_update import sketch_update, sketch_update_ref

__all__ = ["sketch_update", "sketch_update_ref"]
