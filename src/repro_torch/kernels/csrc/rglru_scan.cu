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
// One thread per channel looping over S (4096 threads at one prefill row)
// leaves most of the card idle, so the long route splits S as well:
//
//   * chunked (S > SHORT_S): the pair (a, b) composes associatively,
//     (a2, b2) after (a1, b1) = (a2 a1, a2 b1 + b2), so a tile of 32
//     channels x T steps (one warp per SEG-step segment, a lane per
//     channel, coalesced along R) computes its aggregate from registers,
//     gets its carry-in by decoupled look-back over per-tile flags
//     (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
//     Look-back", 2016), then replays its steps from the same registers
//     with the carry and writes y: a and bx are read from device memory
//     once, and B·(R/32)·(S/T) tiles fill the card. Tiles take a ticket in
//     launch order (an atomic counter), and a tile only waits on tiles with
//     earlier tickets, which are running or done: no deadlock whatever
//     order the blocks are scheduled in. Within a tile the steps run in the
//     plain version's order from the carry; only the carries are composed
//     in another association (a few ulps of |h|).
//   * sequential (S <= SHORT_S: verify and extend steps): one thread per
//     channel, h in a register, kUnroll steps' loads issued together.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int NT = 128;       // sequential route: threads per block, one channel each
constexpr int kUnroll = 8;    // time steps whose loads are issued together
constexpr int SHORT_S = 64;   // the longest S on the sequential route
constexpr int SEG = 16;       // chunked route: steps of a warp's segment
constexpr int NW = 8;         // segments (warps) of a tile
constexpr int T = SEG * NW;   // steps of a tile
constexpr int CH = 32;        // channels of a tile (one warp's lanes)

// per-tile flags of the look-back
constexpr int kAggregate = 1;  // the tile's own (A, B) is published
constexpr int kInclusive = 2;  // the state after the tile is published

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// every lane's writes before it, then the flag (lane 0)
__device__ __forceinline__ void publish(int* flag, int value, int lane) {
  __threadfence();
  __syncwarp();
  if (lane == 0) asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(flag), "r"(value) : "memory");
}

// a flag that never comes traps (a launch error) instead of hanging the card
__device__ __forceinline__ int wait_flag(const int* flag) {
  for (uint32_t spins = 0;; ++spins) {
    const int f = load_acquire(flag);
    if (f != 0) return f;
    if (spins == (1u << 26)) __trap();
    __nanosleep(32);
  }
}

// tiles in ticket order: chunk-major, so a tile's predecessor along S
// (same row and channels, the chunk before) has an earlier ticket
template <typename TO>
__global__ void __launch_bounds__(NW * 32, 3)
rglru_scan_chunked(const float* __restrict__ a, const float* __restrict__ bx,
                   const float* __restrict__ h0, TO* __restrict__ y,
                   float* __restrict__ h_last, int* __restrict__ flags,
                   float* __restrict__ agg, int B, int S, int R, int ntiles) {
  __shared__ int s_ticket;
  __shared__ float sA[NW][CH], sB[NW][CH], sCarry[NW][CH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_ticket = atomicAdd(flags + ntiles, 1);
  __syncthreads();
  const int t = s_ticket, ngroups = (R + CH - 1) / CH, stride = B * ngroups;
  const int group = t % ngroups, b = (t / ngroups) % B, chunk = t / stride;
  const int r = group * CH + lane, s0 = chunk * T + warp * SEG;
  const bool rok = r < R;

  const size_t at0 = ((size_t)b * S + s0) * R + r;  // this lane's first step
  const float* pa = a + at0;
  const float* pb = bx + at0;
  float av[SEG], bv[SEG];
#pragma unroll
  for (int u = 0; u < SEG; ++u) {
    const bool ok = rok && s0 + u < S;
    av[u] = ok ? pa[u * R] : 1.f;    // past S: the identity step
    bv[u] = ok ? pb[u * R] : 0.f;
  }
  float A = 1.f, Bs = 0.f;
#pragma unroll
  for (int u = 0; u < SEG; ++u) {
    Bs = fmaf(av[u], Bs, bv[u]);
    A *= av[u];
  }
  sA[warp][lane] = A;
  sB[warp][lane] = Bs;
  __syncthreads();

  if (warp == 0) {
    float* mine = agg + (size_t)t * 3 * CH;  // aggregate A, B; inclusive state
    float carry;
    if (chunk == 0) {
      carry = (h0 != nullptr && rok) ? h0[(size_t)b * R + r] : 0.f;
    } else {
      float TA = 1.f, TB = 0.f;
      for (int w = 0; w < NW; ++w) {
        TB = fmaf(sA[w][lane], TB, sB[w][lane]);
        TA *= sA[w][lane];
      }
      mine[lane] = TA;
      mine[CH + lane] = TB;
      publish(flags + t, kAggregate, lane);
      float RA = 1.f, RB = 0.f;  // the tiles between the one read and this one
      for (int j = t - stride;; j -= stride) {
        const int f = wait_flag(flags + j);
        const float* theirs = agg + (size_t)j * 3 * CH;
        if (f == kInclusive) {
          carry = fmaf(RA, theirs[2 * CH + lane], RB);
          break;
        }
        RB = fmaf(RA, theirs[CH + lane], RB);
        RA *= theirs[lane];
      }
    }
    float hc = carry;
    for (int w = 0; w < NW; ++w) {
      sCarry[w][lane] = hc;
      hc = fmaf(sA[w][lane], hc, sB[w][lane]);
    }
    mine[2 * CH + lane] = hc;
    publish(flags + t, kInclusive, lane);
  }
  __syncthreads();

  float h = sCarry[warp][lane];
  TO* py = y + at0;
#pragma unroll
  for (int u = 0; u < SEG; ++u) {
    h = fmaf(av[u], h, bv[u]);
    if (rok && s0 + u < S) py[u * R] = repro::from_f<TO>(h);
  }
  if (rok && s0 < S && S <= s0 + SEG) h_last[(size_t)b * R + r] = h;
}

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

template <typename TO>
int launch(const float* a, const float* bx, const float* h0, void* y, float* h_last,
           int* flags, float* agg, int B, int S, int R, cudaStream_t st) {
  TO* yo = static_cast<TO*>(y);
  if (S <= SHORT_S) {
    rglru_scan_kernel<TO><<<dim3((R + NT - 1) / NT, B), NT, 0, st>>>(a, bx, h0, yo, h_last,
                                                                      S, R);
  } else {
    if (flags == nullptr || agg == nullptr) return (int)cudaErrorInvalidValue;
    const int ntiles = B * ((R + CH - 1) / CH) * ((S + T - 1) / T);
    rglru_scan_chunked<TO><<<ntiles, NW * 32, 0, st>>>(a, bx, h0, yo, h_last, flags, agg, B,
                                                        S, R, ntiles);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// a, bx [B, S, R] float32; h0 [B, R] float32 or null; y [B, S, R] in
// out_dtype (repro::DType); h_last [B, R] float32; all contiguous on the
// device. S > SHORT_S takes the chunked route and its scratch: flags
// int32 [ntiles + 1], zeroed (the per-tile flags, then the ticket counter),
// agg float32 [ntiles, 3, 32], ntiles = B * ceil(R / 32) * ceil(S / T);
// S <= SHORT_S takes them null. Returns cudaGetLastError() of the launch.
extern "C" int rglru_scan_fwd(const void* a, const void* bx, const void* h0, void* y,
                              void* h_last, void* flags, void* agg, int B, int S, int R,
                              int out_dtype, void* stream) {
  if (B <= 0 || R <= 0 || S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(bx);
  const float* ph = static_cast<const float*>(h0);
  float* hl = static_cast<float*>(h_last);
  int* fl = static_cast<int*>(flags);
  float* ag = static_cast<float*>(agg);
  if (out_dtype == repro::kF32)
    return launch<float>(pa, pb, ph, y, hl, fl, ag, B, S, R, st);
  if (out_dtype == repro::kBF16)
    return launch<__nv_bfloat16>(pa, pb, ph, y, hl, fl, ag, B, S, R, st);
  return (int)cudaErrorInvalidValue;
}
