"""repro_torch: the PyTorch / CUDA port of the over-the-air DSGD library.

A second package beside ``repro`` (the JAX reference), mirroring it module
for module: the same configs, data, round and training loop, with the
reference's Pallas kernels rewritten by hand as CUDA kernels for Hopper.
It imports torch and numpy only, never jax and nothing of ``repro``.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"
