"""Device ops: the plain attention path, the CUDA kernel wrappers, and
dense linear projections."""
