// Causal flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention. Same algorithm: online softmax over key tiles with
// float32 (m, l, acc) state, causal mask, optional sliding window, keys at
// positions >= T masked. Two differences, both asked of the port:
//   * native GQA: k, v are [B, T, K, hd] and query head h reads KV head
//     h / (H / K) -- no repeat_kv copy of the cache;
//   * q_start: query row i sits at position q_start + i (key j at position
//     j), so the one kernel serves prefill (q_start = 0), dense extend over
//     a cache row and paged extend over a gathered page view.
//
// What bounds it on an H100: at the prefill shapes of qwen2.5-3b
// (S = T <= 2048, H = 16, hd = 128) the work is ~4·S²/2·H·hd FLOPs against
// a few MB of q/k/v, i.e. compute bound. This first version computes on
// the CUDA cores in float32 (scalar FMAs from shared memory), which keeps
// the float32 parity path exact to the reference's 2e-5 and the bf16 path
// to its 2e-2, but reaches only a small share of the tensor-core peak that
// bounds it: wgmma/TMA tiles are later work. Design: one block of 128
// threads per (16-query tile, head, batch row); 8 threads share a query
// row, each owning 4 of the 32 keys of a tile for the scores and hd/8 of
// the output columns for P·V; tiles arrive by 16-byte vector loads, and
// tiles above the causal diagonal (and below a sliding window) are never
// loaded.
#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int BQ = 16;   // query rows per block
constexpr int BK = 32;   // keys per tile
constexpr int NT = 128;  // threads per block: 8 per query row

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int S, int Tk, int H, int K, int q_start, int window,
          float scale) {
  constexpr int DPT = HD / 8;  // output columns per thread
  constexpr int QS = HD + 1;   // padded shared-memory row strides
  constexpr int KS = HD + 1;
  constexpr int PS = BK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;            // [BQ][QS]
  float* sK = sQ + BQ * QS;    // [BK][KS]
  float* sV = sK + BK * KS;    // [BK][HD]
  float* sP = sV + BK * HD;    // [BQ][PS]

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, r = tid >> 3, l8 = tid & 7;
  const int q0 = qb * BQ;
  const int nq = min(BQ, S - q0);

  constexpr int VN = repro::Vec<T>::N;  // elements per 16-byte load
  constexpr int VPR = HD / VN;          // vector loads per row
#pragma unroll
  for (int i = tid; i < BQ * VPR; i += NT) {
    const int rr = i / VPR, d0 = (i - rr * VPR) * VN;
    float x[VN];
    if (rr < nq) {
      repro::Vec<T>::load(q + ((size_t)(b * S + q0 + rr) * H + h) * HD + d0, x);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) sQ[rr * QS + d0 + e] = x[e];
  }

  const int my_pos = q_start + q0 + r;
  const int k_end = min(Tk, q_start + q0 + nq);       // causal: keys <= last query
  int k_beg = window > 0 ? max(0, q_start + q0 - window + 1) : 0;
  k_beg = (k_beg / BK) * BK;

  const size_t kv_row = (size_t)K * HD;               // stride between positions
  const T* kb = k + (size_t)b * Tk * kv_row + (size_t)kh * HD;
  const T* vb = v + (size_t)b * Tk * kv_row + (size_t)kh * HD;

  float m = kNegInf, l = 0.f, acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int k0 = k_beg; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and sQ is written)
#pragma unroll
    for (int i = tid; i < BK * VPR; i += NT) {
      const int c = i / VPR, d0 = (i - c * VPR) * VN;
      const int kp = k0 + c;
      float kx[VN], vx[VN];
      if (kp < Tk) {
        repro::Vec<T>::load(kb + kp * kv_row + d0, kx);
        repro::Vec<T>::load(vb + kp * kv_row + d0, vx);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        sK[c * KS + d0 + e] = kx[e];
        sV[c * HD + d0 + e] = vx[e];
      }
    }
    __syncthreads();

    // this thread's 4 keys share each q element it reads
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const float* qr = sQ + r * QS;
#pragma unroll 16
    for (int d = 0; d < HD; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = fmaf(qd, sK[(l8 + 8 * j) * KS + d], s[j]);
    }
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kp = k0 + l8 + 8 * j;
      const bool ok = kp < Tk && kp <= my_pos && (window <= 0 || my_pos - kp < window);
      s[j] = ok ? s[j] * scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    // the 8 threads of a row are adjacent lanes of one warp
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = expf(s[j] - m_new);
      sum += p;
      sP[r * PS + l8 + 8 * j] = repro::round_to<T>(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();  // row r's probabilities were written by its own 8 lanes

#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = l8 + 8 * i;
      float a = 0.f;
#pragma unroll 8
      for (int c = 0; c < BK; ++c) a = fmaf(sP[r * PS + c], sV[c * HD + d], a);
      acc[i] = acc[i] * corr + a;
    }
  }

  if (r < nq) {
    const float den = fmaxf(l, 1e-30f);
    T* orow = o + ((size_t)(b * S + q0 + r) * H + h) * HD;
#pragma unroll
    for (int i = 0; i < DPT; ++i) orow[l8 + 8 * i] = repro::from_f<T>(acc[i] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Tk,
           int H, int K, int q_start, int window, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
  auto kern = flash_fwd<T, HD>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                   static_cast<const T*>(v), static_cast<T*>(o), S, Tk,
                                   H, K, q_start, window, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int B, int S,
                int Tk, int H, int K, int hd, int q_start, int window, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, Tk, H, K, q_start, window, st);
    case 32: return launch<T, 32>(q, k, v, o, B, S, Tk, H, K, q_start, window, st);
    case 64: return launch<T, 64>(q, k, v, o, B, S, Tk, H, K, q_start, window, st);
    case 128: return launch<T, 128>(q, k, v, o, B, S, Tk, H, K, q_start, window, st);
    case 256: return launch<T, 256>(q, k, v, o, B, S, Tk, H, K, q_start, window, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o [B, S, H, hd]; k, v [B, T, K, hd]; all contiguous, one dtype.
// window <= 0: no sliding window. Returns cudaGetLastError() of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int T, int H, int K, int hd,
                                   int q_start, int window, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return dispatch_hd<float>(q, k, v, o, B, S, T, H, K, hd, q_start, window, st);
  if (dtype == repro::kBF16)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, T, H, K, hd, q_start, window, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
