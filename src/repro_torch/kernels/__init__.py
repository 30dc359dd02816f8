"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: flash_attention, decode_attention, paged_decode_attention, the
multi-query (speculative verify) forms spec_decode_attention and
paged_spec_decode_attention, and spec_scan.accept_len (CUDA C++ sources in
csrc/, built by build.py at first launch)."""
