"""repro_torch — the PyTorch/CUDA port of the CarbonFlex reproduction.

The JAX package ``repro`` is the reference; this package grows beside it
slice by slice with the same module layout.  It imports torch and numpy,
never JAX and nothing of ``repro``.  Host logic stays float64 numpy,
operation for operation as in the reference; the knowledge-base lookup runs
on the device, through hand-written kernels on CUDA.
"""
