"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: flash_attention, decode_attention, paged_decode_attention
(CUDA C++ sources in csrc/, built by build.py at first launch)."""
