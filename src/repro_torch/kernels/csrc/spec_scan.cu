// Accepted-prefix length of speculative decoding for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/spec_scan.py::accept_len:
// m[b] = number of leading accepted flags in accept[b, :draft_lens[b]],
// i.e. min(first rejected column below draft_lens[b], draft_lens[b]).
//
// Design: one warp per row. Each lane takes one column of a 32-column
// window; __ballot_sync over (flag == 0 && col < len) marks the rejected
// columns and __ffs of the ballot gives the first one. Rows wider than 32
// loop over windows and stop at the first window with a rejection. The
// flags are read as the bytes of a torch.bool tensor (0 / 1), so the
// wrapper needs no conversion pass.
//
// What bounds it on an H100: nothing but the launch. B x S flag bytes plus
// 8 bytes per row is a few KB at serving shapes (B = slots, S = spec_len+1),
// nanoseconds of HBM time against microseconds of launch latency.
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 4;  // warps per block

__global__ void __launch_bounds__(32 * kRowsPerBlock)
accept_len_kernel(const unsigned char* __restrict__ accept, const int* __restrict__ lens,
                  int* __restrict__ out, int B, int S) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warp leaves together: b is uniform in a warp
  const int len = lens[b];
  const unsigned char* row = accept + (size_t)b * S;
  int first_bad = S;
  for (int base = 0; base < S; base += 32) {
    const int col = base + lane;
    const bool bad = col < S && col < len && row[col] == 0;
    const unsigned mask = __ballot_sync(0xffffffffu, bad);
    if (mask != 0u) {
      first_bad = base + __ffs(mask) - 1;
      break;
    }
  }
  if (lane == 0) out[b] = min(first_bad, len);
}

}  // namespace

// accept [B, S] bool (1 byte each), draft_lens [B] int32, out [B] int32, all
// on the device. Returns cudaGetLastError() of the launch.
extern "C" int accept_len_fwd(const void* accept, const int* draft_lens, int* out,
                              int B, int S, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  accept_len_kernel<<<blocks, 32 * kRowsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(accept), draft_lens, out, B, S);
  return (int)cudaGetLastError();
}
