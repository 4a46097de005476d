"""PyTorch/CUDA port of the sketching system (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
module layout so each counterpart is easy to find. What is ported so far
is the monitored serving path: dense-attention decoder models
(``models``), the "res" EMA activation sketches (``sketches``), their
fused update kernel written in CUDA C++ for Hopper (``kernels``,
``csrc``), ring-buffer monitoring (``core.monitor``), telemetry and the
serving engine (``serve``). ``interop`` carries weights and sketch state
over from the JAX package for differential tests.

Entry points run on the CUDA device unless the caller asks for the CPU;
on CPU tensors every kernel wrapper computes its plain PyTorch version.
"""
