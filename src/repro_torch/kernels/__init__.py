"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: flash_attention, decode_attention, paged_decode_attention, the
multi-query (speculative verify) forms spec_decode_attention and
paged_spec_decode_attention, spec_scan.accept_len, rglru_scan and
mlstm_chunk (CUDA C++ sources in csrc/, built by build.py at first
launch). The four decode forms share one split-K kernel pair
(split_decode.py)."""
