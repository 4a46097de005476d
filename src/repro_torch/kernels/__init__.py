"""Hand-written Hopper kernels of the port, each module holding a wrapper,
its plain PyTorch version (taken for CPU tensors) and a launch counter:

    sketch_update   fused EMA X/Y/Z update, one pass over A
                    (replaces src/repro/kernels/sketch_update.py)
    psparse_update  the same update with hashed p-sparse projections,
                    reading only their support rows of A
                    (replaces src/repro/kernels/psparse_update.py)

The package re-exports nothing: a function re-exported under its
module's name would hide the module (``repro_torch.kernels.psparse_update``
would resolve to the function).
"""
