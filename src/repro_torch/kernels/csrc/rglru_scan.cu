// RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py::rglru_scan:
// h_t = a_t * h_{t-1} + bx_t over [B, S, R], channels independent, the state
// h carried in float32. Two differences from it, both those of the JAX
// package's default (XLA) path, src/repro/models/rglru.py:82-103, which the
// port follows: a and bx stay float32 (the Pallas path rounds them to the
// activation dtype first), and h_last is the float32 register state after
// the last position (the Pallas path re-widens the rounded y[:, -1]). An
// optional h0 [B, R] starts the recurrence (the Pallas kernel starts at 0
// and its caller folds a_0 * h0 into bx_0).
//
// What bounds it on an H100: bytes. Per (row, step, channel) it reads 8
// bytes and writes 2 or 4, and does one FMA: at recurrentgemma's largest
// prefill bucket (B=1, S=4096, R=4096) about 168 MB, ~0.05 ms of HBM time.
// Design: one thread per (b, r) channel with h in a register, looping over
// S; neighbouring threads read neighbouring channels, so every load and
// store is coalesced along R. The loads of a step do not depend on h, so the
// loop is unrolled by kUnroll steps to keep that many loads in flight per
// thread. The time loop is sequential inside a thread; B*R threads (4096 at
// one prefill row) are fewer than the card can keep busy, which is why this
// first version stays well above its bound (a chunked two-pass scan over S
// is later work).
#include "common.cuh"

namespace {

constexpr int NT = 128;       // threads per block, one channel each
constexpr int kUnroll = 8;    // time steps whose loads are issued together

template <typename TO>
__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ bx,
                  const float* __restrict__ h0, TO* __restrict__ y,
                  float* __restrict__ h_last, int S, int R) {
  const int r = blockIdx.x * NT + threadIdx.x;
  const int b = blockIdx.y;
  if (r >= R) return;
  const size_t base = (size_t)b * S * R + r;
  float h = h0 != nullptr ? h0[(size_t)b * R + r] : 0.f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = a[base + (size_t)(t + u) * R];
      bv[u] = bx[base + (size_t)(t + u) * R];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = fmaf(av[u], h, bv[u]);
      y[base + (size_t)(t + u) * R] = repro::from_f<TO>(h);
    }
  }
  for (; t < S; ++t) {
    h = fmaf(a[base + (size_t)t * R], h, bx[base + (size_t)t * R]);
    y[base + (size_t)t * R] = repro::from_f<TO>(h);
  }
  h_last[(size_t)b * R + r] = h;
}

}  // namespace

// a, bx [B, S, R] float32; h0 [B, R] float32 or null; y [B, S, R] in
// out_dtype (repro::DType); h_last [B, R] float32; all contiguous on the
// device. Returns cudaGetLastError() of the launch.
extern "C" int rglru_scan_fwd(const void* a, const void* bx, const void* h0, void* y,
                              void* h_last, int B, int S, int R, int out_dtype,
                              void* stream) {
  if (B <= 0 || R <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((R + NT - 1) / NT, B);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(bx);
  const float* ph = static_cast<const float*>(h0);
  float* hl = static_cast<float*>(h_last);
  if (out_dtype == repro::kF32) {
    rglru_scan_kernel<float><<<grid, NT, 0, st>>>(pa, pb, ph, static_cast<float*>(y),
                                                  hl, S, R);
  } else if (out_dtype == repro::kBF16) {
    rglru_scan_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(
        pa, pb, ph, static_cast<__nv_bfloat16*>(y), hl, S, R);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
