"""PyTorch/CUDA port of the sketching system (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
module layout so each counterpart is easy to find. What is ported so far:

- the monitored serving path: dense-attention decoder models
  (``models``), the "res" EMA activation sketches (``sketches``),
  ring-buffer monitoring (``core.monitor``), telemetry and the serving
  engine (``serve``);
- the paper MLP trainer (``train.paper_trainer``): reconstruction
  (``core.reconstruct``), sketched backprop (``sketches.linear``), the
  adaptive rank controller (``core.adaptive``), AdamW (``optim``),
  synthetic data (``data``) and p-sparsified projections
  (``sketches.psparse``);
- the two fused sketch-update kernels, written in CUDA C++ for Hopper
  (``kernels``, ``csrc``).

``interop`` carries weights, optimizer state and sketch state over from
the JAX package for differential tests.

Entry points run on the CUDA device unless the caller asks for the CPU;
on CPU tensors every kernel wrapper computes its plain PyTorch version.
"""
