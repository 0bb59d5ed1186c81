"""repro_torch: the bpftime reproduction ported to PyTorch and CUDA for one
NVIDIA H100. It imports torch and never jax or the JAX package `repro`;
the pure-Python front end is copied. See README.md ("PyTorch/CUDA port")."""
