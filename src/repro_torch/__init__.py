"""PyTorch / CUDA port of the serving stack (see README.md, "The PyTorch /
H100 port"). The JAX package ``repro`` is the reference it is held against;
nothing here imports it or JAX."""
