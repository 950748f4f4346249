"""PyTorch/CUDA port of the SLOTH fail-slow detection pipeline.

A sibling of the JAX package ``repro``: the same modules under the same
names (``core/…``, ``kernels/…``), with tensor work in torch on an explicit
device and the two hot kernels (the Fail-Slow Sketch insert and the fused
FailRank step) written by hand in CUDA for Hopper (``csrc/``).  Nothing in
this package imports ``jax`` or ``repro``.

Entry points run on the card (``cuda:0``) unless the caller passes
``device="cpu"``, which selects each kernel's plain torch version.
"""
