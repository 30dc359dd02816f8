// RG-LRU linear recurrence for Hopper (sm_90a): the scan and its gradient.
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
//
// Training keeps the float32 states for the gradient: an optional states
// pointer makes the same launch write them beside y in out_dtype (14 bytes
// an element with a bf16 y, where a float32 y and a rounding pass move 18).
//
// The gradient (rglru_scan_bwd, the backward of the same recurrence; the
// reference's is XLA's autodiff of its associative scan) is the recurrence
// run backwards in time, one launch on the same two routes:
//
//   dh_t = dy_t + a_{t+1} dh_{t+1}   (a_S = 1, dh_S = dh_last or 0)
//   dbx_t = dh_t,  da_t = dh_t h_{t-1}  (h_{-1} = h0 or 0),  dh0 = a_0 dh_0
//
// It reads a, the states and dy once and writes da and dbx: 18 bytes an
// element with a bf16 dy. The shifts are index math, not copies: a step
// reads a one row later and the state one row earlier than itself (a
// tile's edge rows are read by its neighbour too, from L2), and time runs
// backwards through the tickets: the first ticket takes the last chunk.
// Bytes bound it as they bound the forward, so it keeps the forward's
// tiles and coalescing. What it does not keep is the look-back: the
// backward is deterministic (two calls give the same bits, as the flash
// and mLSTM backward kernels do), and a look-back composes whichever
// predecessors have published when it looks. So a tile's carry-in is its
// predecessor's published state and nothing else (a chained scan: 16 hops
// a chain at S = 2048), which the predecessor publishes one FMA after its
// own carry arrives, before it replays its steps, as one 64-bit word a
// channel (value and published bit together: no fence, no flag). Chosen by
// measurement at recurrentgemma-9b's train microbatch ([2, 2048, 4096],
// bf16 dy; device ms by CUDA-graph replay on an H100 80GB HBM3 at 700 W):
// a fixed-order reduce-then-scan (each tile composing every later tile's
// aggregate back to dh_last) took 0.186 where the chain took 0.157 (both
// with a flag behind a fence, the states in registers); in the final form
// the chain costs nothing measurable: 0.150-0.152 chained, 0.151-0.153
// with the wait taken out (wrong values, timing only). What is left is the access
// pattern: three input streams and two output streams in 128-byte rows
// (0.1455, ~62% of the memory rate; the forward's two and two reach ~72%).
// The states are read as each step is written, not held across the wait:
// that keeps 64 registers, 4 blocks an SM and no spill (holding them spilled
// 80 bytes and took 0.164; 5 or 6 blocks an SM spill and are slower).
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
                   float* __restrict__ states, float* __restrict__ h_last,
                   int* __restrict__ flags, float* __restrict__ agg, int B, int S, int R,
                   int ntiles) {
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
    if (rok && s0 + u < S) {
      py[u * R] = repro::from_f<TO>(h);
      if (states != nullptr) states[at0 + (size_t)u * R] = h;
    }
  }
  if (rok && s0 < S && S <= s0 + SEG) h_last[(size_t)b * R + r] = h;
}

template <typename TO>
__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ bx,
                  const float* __restrict__ h0, TO* __restrict__ y,
                  float* __restrict__ states, float* __restrict__ h_last, int S, int R) {
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
      if (states != nullptr) states[base + (size_t)(t + u) * R] = h;
    }
  }
  for (; t < S; ++t) {
    h = fmaf(a[base + (size_t)t * R], h, bx[base + (size_t)t * R]);
    y[base + (size_t)t * R] = repro::from_f<TO>(h);
    if (states != nullptr) states[base + (size_t)t * R] = h;
  }
  h_last[(size_t)b * R + r] = h;
}

// ---- the gradient ----------------------------------------------------------

// A tile's carry, published as one 64-bit word per lane: the value's bits,
// and 1 above them once it is there (the words are zeroed before the
// launch). A lane waits on its own word, and no fence has to order a flag
// after the value: one relaxed store and one relaxed load a hop.
__device__ __forceinline__ void put_carry(unsigned long long* slot, float v) {
  const unsigned long long w = (1ull << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(slot), "l"(w) : "memory");
}

// a carry that never comes traps (a launch error) instead of hanging the card
__device__ __forceinline__ float get_carry(const unsigned long long* slot) {
  for (uint32_t spins = 0;; ++spins) {
    unsigned long long w;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(w) : "l"(slot) : "memory");
    if (w >> 32) return __uint_as_float(static_cast<unsigned>(w));
    if (spins == (1u << 26)) __trap();
    __nanosleep(32);
  }
}

// Tickets in reverse time: ticket t takes chunk nchunks - 1 - t / stride, so
// a tile's predecessor (the chunk after it, whose first step's dh is this
// tile's carry-in) has ticket t - stride, and the first stride tickets take
// the last chunk, which starts from dh_last. carry: ntiles x CH words, then
// the ticket counter.
template <typename TI>
__global__ void __launch_bounds__(NW * 32, 4)
rglru_scan_chunked_bwd(const float* __restrict__ a, const float* __restrict__ hh,
                       const TI* __restrict__ dy, const float* __restrict__ h0,
                       const float* __restrict__ dh_last, float* __restrict__ da,
                       float* __restrict__ dbx, float* __restrict__ dh0,
                       unsigned long long* __restrict__ carry, int B, int S, int R,
                       int ntiles) {
  __shared__ int s_ticket;
  __shared__ float sA[NW][CH], sB[NW][CH], sCarry[NW][CH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_ticket = static_cast<int>(atomicAdd(carry + (size_t)ntiles * CH, 1ull));
  __syncthreads();
  const int t = s_ticket, ngroups = (R + CH - 1) / CH, stride = B * ngroups;
  const int nchunks = (S + T - 1) / T;
  const int group = t % ngroups, b = (t / ngroups) % B, chunk = nchunks - 1 - t / stride;
  const int r = group * CH + lane, s0 = chunk * T + warp * SEG;
  const bool rok = r < R;

  // step s0 + u reads a at s0 + u + 1 (1 past S - 1) and dy at s0 + u into
  // registers now, and the state at s0 + u - 1 (h0, or 0, before step 0)
  // as it writes the step: 64 registers, 4 blocks an SM, no spill
  const long long at0 = ((long long)b * S + s0) * R + r;
  float ap[SEG], gv[SEG];
#pragma unroll
  for (int u = 0; u < SEG; ++u) {
    const int s = s0 + u;
    ap[u] = (rok && s + 1 < S) ? a[at0 + (long long)(u + 1) * R] : 1.f;
    gv[u] = (rok && s < S && dy != nullptr) ? repro::to_f(dy[at0 + (long long)u * R]) : 0.f;
  }
  // the segment's aggregate, latest step first: dh at s0 = A dh(s0 + SEG) + Bs
  float A = 1.f, Bs = 0.f;
#pragma unroll
  for (int u = SEG - 1; u >= 0; --u) {
    Bs = fmaf(ap[u], Bs, gv[u]);
    A *= ap[u];
  }
  sA[warp][lane] = A;
  sB[warp][lane] = Bs;
  __syncthreads();

  if (warp == 0) {
    float TA = 1.f, TB = 0.f;
    for (int w = NW - 1; w >= 0; --w) {
      TB = fmaf(sA[w][lane], TB, sB[w][lane]);
      TA *= sA[w][lane];
    }
    const float cin = t < stride
        ? ((dh_last != nullptr && rok) ? dh_last[(size_t)b * R + r] : 0.f)
        : get_carry(carry + (size_t)(t - stride) * CH + lane);
    if (chunk > 0) put_carry(carry + (size_t)t * CH + lane, fmaf(TA, cin, TB));
    float d = cin;
    for (int w = NW - 1; w >= 0; --w) {
      sCarry[w][lane] = d;
      d = fmaf(sA[w][lane], d, sB[w][lane]);
    }
  }
  __syncthreads();

  const float hstart = (h0 != nullptr && rok) ? h0[(size_t)b * R + r] : 0.f;
  float d = sCarry[warp][lane];
#pragma unroll
  for (int u = SEG - 1; u >= 0; --u) {
    d = fmaf(ap[u], d, gv[u]);
    if (rok && s0 + u < S) {
      const long long i = at0 + (long long)u * R;
      dbx[i] = d;
      da[i] = d * (s0 + u > 0 ? hh[i - R] : hstart);
    }
  }
  if (dh0 != nullptr && rok && s0 == 0) dh0[(size_t)b * R + r] = a[at0] * d;
}

template <typename TI>
__global__ void __launch_bounds__(NT)
rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ hh,
                      const TI* __restrict__ dy, const float* __restrict__ h0,
                      const float* __restrict__ dh_last, float* __restrict__ da,
                      float* __restrict__ dbx, float* __restrict__ dh0, int S, int R) {
  const int r = blockIdx.x * NT + threadIdx.x;
  const int b = blockIdx.y;
  if (r >= R) return;
  const size_t base = (size_t)b * S * R + r;
  const float hstart = h0 != nullptr ? h0[(size_t)b * R + r] : 0.f;
  float d = dh_last != nullptr ? dh_last[(size_t)b * R + r] : 0.f;
  float an = 1.f;  // a one step later than the step at hand
  int t = S;
  // the steps past the last whole group of kUnroll, latest first
  for (; t > (S / kUnroll) * kUnroll; --t) {
    const size_t i = base + (size_t)(t - 1) * R;
    d = fmaf(an, d, dy != nullptr ? repro::to_f(dy[i]) : 0.f);
    dbx[i] = d;
    da[i] = d * (t > 1 ? hh[i - R] : hstart);
    an = a[i];
  }
  for (; t > 0; t -= kUnroll) {
    const int t0 = t - kUnroll;
    float av[kUnroll], gv[kUnroll], hp[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t i = base + (size_t)(t0 + u) * R;
      av[u] = a[i];
      gv[u] = dy != nullptr ? repro::to_f(dy[i]) : 0.f;
      hp[u] = t0 + u > 0 ? hh[i - R] : hstart;
    }
#pragma unroll
    for (int u = kUnroll - 1; u >= 0; --u) {
      const size_t i = base + (size_t)(t0 + u) * R;
      d = fmaf(an, d, gv[u]);
      dbx[i] = d;
      da[i] = d * hp[u];
      an = av[u];
    }
  }
  if (dh0 != nullptr) dh0[(size_t)b * R + r] = an * d;
}

int tiles(int B, int S, int R) { return B * ((R + CH - 1) / CH) * ((S + T - 1) / T); }

template <typename TO>
int launch(const float* a, const float* bx, const float* h0, void* y, float* states,
           float* h_last, int* flags, float* agg, int B, int S, int R, cudaStream_t st) {
  TO* yo = static_cast<TO*>(y);
  if (S <= SHORT_S) {
    rglru_scan_kernel<TO><<<dim3((R + NT - 1) / NT, B), NT, 0, st>>>(a, bx, h0, yo, states,
                                                                      h_last, S, R);
  } else {
    if (flags == nullptr || agg == nullptr) return (int)cudaErrorInvalidValue;
    const int ntiles = tiles(B, S, R);
    const cudaError_t e = cudaMemsetAsync(flags, 0, sizeof(int) * (ntiles + 1), st);
    if (e != cudaSuccess) return (int)e;
    rglru_scan_chunked<TO><<<ntiles, NW * 32, 0, st>>>(
        a, bx, h0, yo, states, h_last, flags, agg, B, S, R, ntiles);
  }
  return (int)cudaGetLastError();
}

template <typename TI>
int launch_bwd(const float* a, const float* hh, const void* dy, const float* h0,
               const float* dh_last, float* da, float* dbx, float* dh0,
               unsigned long long* carry, int B, int S, int R, cudaStream_t st) {
  const TI* g = static_cast<const TI*>(dy);
  if (S <= SHORT_S) {
    rglru_scan_bwd_kernel<TI><<<dim3((R + NT - 1) / NT, B), NT, 0, st>>>(
        a, hh, g, h0, dh_last, da, dbx, dh0, S, R);
  } else {
    if (carry == nullptr) return (int)cudaErrorInvalidValue;
    const int ntiles = tiles(B, S, R);
    const cudaError_t e = cudaMemsetAsync(
        carry, 0, sizeof(unsigned long long) * ((size_t)ntiles * CH + 1), st);
    if (e != cudaSuccess) return (int)e;
    rglru_scan_chunked_bwd<TI><<<ntiles, NW * 32, 0, st>>>(a, hh, g, h0, dh_last, da, dbx,
                                                           dh0, carry, B, S, R, ntiles);
  }
  return (int)cudaGetLastError();
}

int fwd_entry(const void* a, const void* bx, const void* h0, void* y, void* states,
              void* h_last, void* flags, void* agg, int B, int S, int R, int out_dtype,
              void* stream) {
  if (B <= 0 || R <= 0 || S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(bx);
  const float* ph = static_cast<const float*>(h0);
  float* ps = static_cast<float*>(states);
  float* hl = static_cast<float*>(h_last);
  int* fl = static_cast<int*>(flags);
  float* ag = static_cast<float*>(agg);
  if (out_dtype == repro::kF32)
    return launch<float>(pa, pb, ph, y, ps, hl, fl, ag, B, S, R, st);
  if (out_dtype == repro::kBF16)
    return launch<__nv_bfloat16>(pa, pb, ph, y, ps, hl, fl, ag, B, S, R, st);
  return (int)cudaErrorInvalidValue;
}

int bwd_entry(const void* a, const void* hh, const void* dy, const void* h0,
              const void* dh_last, void* da, void* dbx, void* dh0, void* carry, int B, int S,
              int R, int dy_dtype, void* stream) {
  if (B <= 0 || R <= 0 || S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(a);
  const float* ph = static_cast<const float*>(hh);
  const float* p0 = static_cast<const float*>(h0);
  const float* pl = static_cast<const float*>(dh_last);
  float* pda = static_cast<float*>(da);
  float* pdb = static_cast<float*>(dbx);
  float* pd0 = static_cast<float*>(dh0);
  unsigned long long* cy = static_cast<unsigned long long*>(carry);
  if (dy_dtype == repro::kF32)
    return launch_bwd<float>(pa, ph, dy, p0, pl, pda, pdb, pd0, cy, B, S, R, st);
  if (dy_dtype == repro::kBF16)
    return launch_bwd<__nv_bfloat16>(pa, ph, dy, p0, pl, pda, pdb, pd0, cy, B, S, R, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// a, bx [B, S, R] float32; h0 [B, R] float32 or null; y [B, S, R] in
// out_dtype (repro::DType); states [B, S, R] float32 or null (the float32
// states beside y, for the gradient); h_last [B, R] float32; all contiguous
// on the device. S > SHORT_S takes the chunked route and its scratch: flags
// int32 [ntiles + 1] (the per-tile flags, then the ticket counter; zeroed
// here, on the stream, before the launch), agg float32 [ntiles, 3, 32],
// ntiles = B * ceil(R / 32) * ceil(S / T); S <= SHORT_S takes them null.
// Returns cudaGetLastError() of the launch.
extern "C" int rglru_scan_fwd(const void* a, const void* bx, const void* h0, void* y,
                              void* states, void* h_last, void* flags, void* agg, int B,
                              int S, int R, int out_dtype, void* stream) {
  return fwd_entry(a, bx, h0, y, states, h_last, flags, agg, B, S, R, out_dtype, stream);
}

// a, hh (the states after every step) [B, S, R] float32; dy [B, S, R] in
// dy_dtype or null (0); h0, dh_last [B, R] float32 or null; da, dbx [B, S,
// R] float32; dh0 [B, R] float32, written when h0 is given (else null);
// all contiguous on the device. S > SHORT_S takes the chunked route and its
// scratch: carry 64-bit words [ntiles * 32 + 1] (the tiles' published
// carries, then the ticket counter; zeroed here, on the stream, before the
// launch), ntiles = B * ceil(R / 32) * ceil(S / T); S <= SHORT_S takes it
// null. Returns cudaGetLastError() of the launch.
extern "C" int rglru_scan_bwd(const void* a, const void* hh, const void* dy, const void* h0,
                              const void* dh_last, void* da, void* dbx, void* dh0,
                              void* carry, int B, int S, int R, int dy_dtype, void* stream) {
  return bwd_entry(a, hh, dy, h0, dh_last, da, dbx, dh0, carry, B, S, R, dy_dtype, stream);
}

