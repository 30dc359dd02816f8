// Causal flash attention backward for Hopper (sm_90a): the float32 route,
// the delta kernel both routes run first, and the C entry point.
//
// Replaces the gradient of the Pallas TPU kernel src/repro/kernels/
// flash_attention.py::flash_attention. The reference has no backward kernel
// (its Pallas kernels have no VJP): it trains on XLA's autodiff of
// src/repro/models/attention.py::flash_attention. Same contract as the plain
// version (kernels/flash_attention.py::flash_attention_bwd): given q, k, v,
// the forward's output o and its row log-sum-exp lse, and dO, it returns dq,
// dk, dv of causal attention with native GQA, an optional sliding window
// and q_start; float32 accumulation; outputs in the input dtype.
//
// The entry point flash_attention_bwd runs flash_bwd_delta (delta =
// rowsum(dO ∘ O), float32 [B, H, S]) and then dispatches on dtype: bf16 to
// the tensor-core kernels of flash_attention_bwd_wgmma.cu, float32 to the
// CUDA-core kernels below, because wgmma takes float32 only as TF32, which
// cannot hold the float32 tolerance of 2e-5. A dispatch on type, not a
// fallback.
//
// What bounds the float32 route: operations, five products over the causal
// pairs at the CUDA cores' 67 TFLOP/s. It serves the float32 parity checks
// and float32 training at small widths, so it is written plainly, as the
// forward's float32 kernel is: FA2's two passes without atomics (dK / dV a
// block per 16-key tile walking every visible query tile of every head of
// its KV head; dQ a block per 16-query tile walking its visible key tiles),
// 8 threads sharing a row, tiles in padded shared memory, every sum in one
// order, so two calls on the same inputs give the same bits.
#include "common.cuh"

namespace {

constexpr int NT = 128;   // threads per block: 8 per row
constexpr int BKB = 16;   // dK / dV block: keys per block
constexpr int BQB = 32;   // dK / dV block: queries per tile
constexpr int BQQ = 16;   // dQ block: queries per block
constexpr int BKQ = 32;   // dQ block: keys per tile

// delta[b, h, s] = sum over d of dO[b, s, h, d] · O[b, s, h, d]: a warp a row
template <typename T>
__global__ void flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                                float* __restrict__ delta, int rows, int S, int H, int hd) {
  const int row = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  constexpr int VN = repro::Vec<T>::N;
  const T* orow = o + (size_t)row * hd;
  const T* drow = dout + (size_t)row * hd;
  float acc = 0.f;
  for (int c = lane; c < hd / VN; c += 32) {
    float x[VN], y[VN];
    repro::Vec<T>::load(orow + c * VN, x);
    repro::Vec<T>::load(drow + c * VN, y);
#pragma unroll
    for (int e = 0; e < VN; ++e) acc = fmaf(x[e], y[e], acc);
  }
  acc = repro::warp_sum(acc);
  if (lane == 0) {
    const int h = row % H, s = (row / H) % S, b = row / (H * S);
    delta[((size_t)b * H + h) * S + s] = acc;
  }
}

// rows [r0, r0 + n) of one head of a [.., rows, heads, HD] float32 tensor into
// shared memory of row stride HD + 1, zeros past `limit`
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int n,
                                          int limit, int heads, int head, int b, int tid) {
  for (int i = tid; i < n * HD; i += NT) {
    const int rr = i / HD, d = i - rr * HD, p = r0 + rr;
    dst[rr * (HD + 1) + d] =
        p < limit ? src[((size_t)(b * limit + p) * heads + head) * HD + d] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, int S, int Tk, int H,
                   int K, int q_start, int window, float scale) {
  constexpr int DPT = HD / 8, RS = HD + 1, PS = BQB + 1;
  extern __shared__ float smem[];
  float* sK = smem;               // [BKB][RS]
  float* sV = sK + BKB * RS;      // [BKB][RS]
  float* sQ = sV + BKB * RS;      // [BQB][RS]
  float* sO = sQ + BQB * RS;      // dO [BQB][RS]
  float* sP = sO + BQB * RS;      // [BKB][PS]
  float* sS = sP + BKB * PS;      // dS [BKB][PS]
  float* sL = sS + BKB * PS;      // lse [BQB]
  float* sDl = sL + BQB;          // delta [BQB]

  const int k0 = blockIdx.x * BKB, kh = blockIdx.y, b = blockIdx.z;
  const int Gq = H / K;
  const int tid = threadIdx.x, r = tid >> 3, l8 = tid & 7;
  const int my_key = k0 + r;
  load_rows<HD>(sK, k, k0, BKB, Tk, K, kh, b, tid);
  load_rows<HD>(sV, v, k0, BKB, Tk, K, kh, b, tid);
  // the query rows that some key of the tile sees: [lo, hi)
  const int lo = max(0, k0 - q_start);
  const int hi = window > 0 ? min(S, k0 + BKB - 1 + window - q_start) : S;

  float dka[DPT], dva[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) dka[i] = dva[i] = 0.f;
  for (int g = 0; g < Gq && hi > lo; ++g) {
    const int h = kh * Gq + g;
    for (int q0 = (lo / BQB) * BQB; q0 < hi; q0 += BQB) {
      __syncthreads();  // the previous tile is consumed (and sK, sV are written)
      load_rows<HD>(sQ, q, q0, BQB, S, H, h, b, tid);
      load_rows<HD>(sO, dout, q0, BQB, S, H, h, b, tid);
      if (tid < BQB) {
        const int qi = q0 + tid;
        const size_t at = ((size_t)b * H + h) * S + qi;
        sL[tid] = qi < S ? lse[at] : INFINITY;  // rows past S: P = 0
        sDl[tid] = qi < S ? delta[at] : 0.f;
      }
      __syncthreads();

      // this thread's 4 queries: Sᵀ and dPᵀ entries of its key row
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      const float* kr = sK + r * RS;
      const float* vr = sV + r * RS;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        const float kd = kr[d], vd = vr[d];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[j] = fmaf(kd, sQ[(l8 + 8 * j) * RS + d], s[j]);
          dp[j] = fmaf(vd, sO[(l8 + 8 * j) * RS + d], dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = l8 + 8 * j, qpos = q_start + q0 + c;
        const bool ok = my_key <= qpos && (window <= 0 || qpos - my_key < window);
        const float p = ok ? expf(s[j] * scale - sL[c]) : 0.f;
        sP[r * PS + c] = p;
        sS[r * PS + c] = p * (dp[j] - sDl[c]);
      }
      __syncwarp();  // row r's entries were written by its own 8 lanes

#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const int d = l8 + 8 * i;
        float a = 0.f, c2 = 0.f;
#pragma unroll 8
        for (int c = 0; c < BQB; ++c) {
          a = fmaf(sP[r * PS + c], sO[c * RS + d], a);
          c2 = fmaf(sS[r * PS + c], sQ[c * RS + d], c2);
        }
        dva[i] += a;
        dka[i] += c2;
      }
    }
  }
  if (my_key < Tk) {
    const size_t at = ((size_t)(b * Tk + my_key) * K + kh) * HD;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      dk[at + l8 + 8 * i] = dka[i] * scale;
      dv[at + l8 + 8 * i] = dva[i];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int S, int Tk, int H, int K, int q_start,
                 int window, float scale) {
  constexpr int DPT = HD / 8, RS = HD + 1, PS = BKQ + 1;
  extern __shared__ float smem[];
  float* sQ = smem;               // [BQQ][RS]
  float* sO = sQ + BQQ * RS;      // dO [BQQ][RS]
  float* sK = sO + BQQ * RS;      // [BKQ][RS]
  float* sV = sK + BKQ * RS;      // [BKQ][RS]
  float* sS = sV + BKQ * RS;      // dS [BQQ][PS]

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, r = tid >> 3, l8 = tid & 7;
  const int q0 = qb * BQQ, nq = min(BQQ, S - q0);
  load_rows<HD>(sQ, q, q0, BQQ, S, H, h, b, tid);
  load_rows<HD>(sO, dout, q0, BQQ, S, H, h, b, tid);
  const int my_pos = q_start + q0 + r;
  const size_t at = ((size_t)b * H + h) * S + q0 + r;
  const float lse_r = r < nq ? lse[at] : INFINITY, delta_r = r < nq ? delta[at] : 0.f;
  const int k_end = min(Tk, q_start + q0 + nq);       // causal: keys <= last query
  int k_beg = window > 0 ? max(0, q_start + q0 - window + 1) : 0;
  k_beg = (k_beg / BKQ) * BKQ;

  float dqa[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) dqa[i] = 0.f;
  for (int k0 = k_beg; k0 < k_end; k0 += BKQ) {
    __syncthreads();  // the previous tile is consumed (and sQ, sO are written)
    load_rows<HD>(sK, k, k0, BKQ, Tk, K, kh, b, tid);
    load_rows<HD>(sV, v, k0, BKQ, Tk, K, kh, b, tid);
    __syncthreads();

    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    const float* qr = sQ + r * RS;
    const float* dr = sO + r * RS;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float qd = qr[d], dd = dr[d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = fmaf(qd, sK[(l8 + 8 * j) * RS + d], s[j]);
        dp[j] = fmaf(dd, sV[(l8 + 8 * j) * RS + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kp = k0 + l8 + 8 * j;
      const bool ok = kp < Tk && kp <= my_pos && (window <= 0 || my_pos - kp < window);
      const float p = ok ? expf(s[j] * scale - lse_r) : 0.f;
      sS[r * PS + l8 + 8 * j] = p * (dp[j] - delta_r);
    }
    __syncwarp();  // row r's entries were written by its own 8 lanes

#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = l8 + 8 * i;
      float a = 0.f;
#pragma unroll 8
      for (int c = 0; c < BKQ; ++c) a = fmaf(sS[r * PS + c], sK[c * RS + d], a);
      dqa[i] += a;
    }
  }
  if (r < nq) {
    float* drow = dq + ((size_t)(b * S + q0 + r) * H + h) * HD;
#pragma unroll
    for (int i = 0; i < DPT; ++i) drow[l8 + 8 * i] = dqa[i] * scale;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
               int S, int Tk, int H, int K, int q_start, int window, cudaStream_t st) {
  const float scale = 1.0f / sqrtf((float)HD);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* of = static_cast<const float*>(dout);
  const size_t smem_kv = sizeof(float) * ((2 * BKB + 2 * BQB) * (HD + 1) +
                                          2 * BKB * (BQB + 1) + 2 * BQB);
  auto kv = flash_bwd_dkdv_f32<HD>;
  cudaError_t e = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_kv);
  if (e != cudaSuccess) return (int)e;
  kv<<<dim3((Tk + BKB - 1) / BKB, K, B), NT, smem_kv, st>>>(
      qf, kf, vf, of, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), S, Tk, H,
      K, q_start, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem_q = sizeof(float) * ((2 * BQQ + 2 * BKQ) * (HD + 1) + BQQ * (BKQ + 1));
  auto dqk = flash_bwd_dq_f32<HD>;
  e = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  dqk<<<dim3((S + BQQ - 1) / BQQ, H, B), NT, smem_q, st>>>(
      qf, kf, vf, of, lse, delta, static_cast<float*>(dq), S, Tk, H, K, q_start, window,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, int B, int S, int H, int hd,
                 cudaStream_t st) {
  const int rows = B * S * H, warps = 8;
  flash_bwd_delta<T><<<(rows + warps - 1) / warps, 32 * warps, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, S, H, hd);
  return (int)cudaGetLastError();
}

}  // namespace

namespace repro {
int flash_attention_bwd_wgmma(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, void* dq, void* dk,
                              void* dv, float* part, int B, int S, int T, int H, int K,
                              int hd, int q_start, int window, int nsplit, cudaStream_t st);
}

// q, o, dout, dq [B, S, H, hd]; k, v, dk, dv [B, T, K, hd]; all contiguous,
// one dtype, 16-byte aligned, T >= 1, H a multiple of K; lse (the forward's)
// and delta (scratch this call fills) float32 [B, H, S]; window <= 0: no
// sliding window. bf16: the tensor-core route, whose dK / dV blocks split the
// G = H / K query heads of a KV head in nsplit parts (G a multiple of
// nsplit), each writing float32 partials to part [2, nsplit, B, T, K, hd]
// (null when nsplit is 1); float32: the CUDA-core route (nsplit 1). Returns
// the first non-zero cudaGetLastError() of its launches.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, void* part, int B, int S, int T, int H,
                                   int K, int hd, int q_start, int window, int nsplit,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K < 1 || H % K != 0 || nsplit < 1 || (H / K) % nsplit != 0 ||
      (nsplit > 1 && (part == nullptr || dtype != repro::kBF16)))
    return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  if (dtype == repro::kF32) {
    int err = launch_delta<float>(o, dout, d, B, S, H, hd, st);
    if (err != 0) return err;
    switch (hd) {
      case 16: return launch_f32<16>(q, k, v, dout, l, d, dq, dk, dv, B, S, T, H, K, q_start, window, st);
      case 32: return launch_f32<32>(q, k, v, dout, l, d, dq, dk, dv, B, S, T, H, K, q_start, window, st);
      case 64: return launch_f32<64>(q, k, v, dout, l, d, dq, dk, dv, B, S, T, H, K, q_start, window, st);
      case 128: return launch_f32<128>(q, k, v, dout, l, d, dq, dk, dv, B, S, T, H, K, q_start, window, st);
      case 256: return launch_f32<256>(q, k, v, dout, l, d, dq, dk, dv, B, S, T, H, K, q_start, window, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == repro::kBF16) {
    int err = launch_delta<__nv_bfloat16>(o, dout, d, B, S, H, hd, st);
    if (err != 0) return err;
    return repro::flash_attention_bwd_wgmma(q, k, v, dout, l, d, dq, dk, dv,
                                            static_cast<float*>(part), B, S, T, H, K, hd,
                                            q_start, window, nsplit, st);
  }
  return (int)cudaErrorInvalidValue;
}
