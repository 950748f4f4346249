"""Hand-written CUDA kernels (``../csrc``) and their plain torch versions.

Each ``ops`` wrapper sends a CPU tensor to the plain version and launches
the kernel for a CUDA tensor; it counts its launches in ``LAUNCHES``.
"""
