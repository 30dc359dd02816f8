// One-token decode attention for Hopper (sm_90a) against a dense (ring) cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention -- one query token per row against a dense (ring) cache
// [B, W, K, hd]; valid positions pos < min(cache_len + 1, W), plus the
// ring-age window mask age < min(window, n_valid + 1) of its lines 47-50
// (entry decode_attention_fwd). The paged kernel has its own split-K source
// (paged_decode_attention.cu).
//
// Multi-query mode (the speculative verify step) replaces the XLA
// spec_attention of src/repro/models/attention.py, which has no Pallas
// counterpart: S queries per row, query s of row b at position
// cache_len[b] + s seeing positions <= its own. A third grid dimension runs
// one block per query position: block (kh, b, s) is the one-token kernel at
// cache length cache_len[b] + s, so the verify step's attention equals S
// successive decode steps bit for bit, and S = 1 is the one-token kernel
// itself. Entry spec_decode_attention_fwd.
//
// Design: one block per (KV head, batch row) computes the G = H / K query
// heads that share that KV head (grouped GQA, no KV repetition), streaming
// the cache in tiles of 32 positions (16-byte vector loads) through shared
// memory with a float32 online softmax. Only positions below n_valid are
// loaded.
//
// What bounds it on an H100: bytes. A step reads each live K/V row once
// (qwen2.5-3b: 2 KV heads x 128 x 2 bytes x 2 per position and layer) and
// does ~4·G·hd FLOPs per position, far below the card's 295 FLOP/byte
// ridge. Known weakness: at 4 slots and 2 KV heads the grid is 8 blocks on
// 132 SMs (40 with S = 5), so a few SMs' load bandwidth, not the card's,
// bounds a step; the split-K design of the paged kernel is the next step
// for this one. In multi-query mode the S blocks of a (head, row) read the
// same K/V; all but the first read mostly hit the 50 MB L2.
#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int TW = 32;    // positions per tile (one warp lane each in softmax)
constexpr int NT = 128;   // threads per block

template <typename T>
__global__ void __launch_bounds__(NT)
decode_fwd(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
           const int* __restrict__ cache_len, T* __restrict__ o, int S, int W, int K,
           int G, int hd, int window, float scale) {
  // q / o are [B, S, H, hd]; block z takes query sq = z at cache_len[b] + sq
  const int kh = blockIdx.x, b = blockIdx.y, sq = blockIdx.z;
  const int H = K * G;
  const int HS = hd + 1;  // padded K-tile row stride
  extern __shared__ float smem[];
  float* sQ = smem;             // [G][hd]
  float* sK = sQ + G * hd;      // [TW][hd + 1]
  float* sV = sK + TW * HS;     // [TW][hd]
  float* sP = sV + TW * hd;     // [G][TW]
  float* sAcc = sP + G * TW;    // [G][hd]
  float* sM = sAcc + G * hd;    // [G]
  float* sL = sM + G;           // [G]
  float* sC = sL + G;           // [G] this tile's rescale factor
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  constexpr int VN = repro::Vec<T>::N;  // elements per 16-byte load
  const int vpr = hd / VN;              // vector loads per row
  const T* qb = q + (((size_t)b * S + sq) * H + (size_t)kh * G) * hd;
  for (int i = tid; i < G * vpr; i += NT) repro::Vec<T>::load(qb + i * VN, sQ + i * VN);
  for (int i = tid; i < G * hd; i += NT) sAcc[i] = 0.f;
  for (int g = tid; g < G; g += NT) {
    sM[g] = kNegInf;
    sL[g] = 0.f;
  }

  const int clen = cache_len[b] + sq;
  const int n_valid = min(clen + 1, W);
  const int ring = clen % W;
  const int win_lim = window > 0 ? min(window, n_valid + 1) : 0;

  for (int t0 = 0; t0 < n_valid; t0 += TW) {
    __syncthreads();  // the previous tile is consumed (and sQ/sAcc are set)
#pragma unroll 4
    for (int i = tid; i < TW * vpr; i += NT) {
      const int c = i / vpr, d0 = (i - c * vpr) * VN;
      const int pos = t0 + c;
      float kx[VN], vx[VN];
      if (pos < n_valid) {
        const size_t row = ((size_t)b * W + pos) * K + kh;
        repro::Vec<T>::load(kc + row * hd + d0, kx);
        repro::Vec<T>::load(vc + row * hd + d0, vx);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        sK[c * HS + d0 + e] = kx[e];
        sV[c * hd + d0 + e] = vx[e];
      }
    }
    __syncthreads();

    for (int i = tid; i < G * TW; i += NT) {
      const int g = i / TW, c = i - g * TW;
      const int pos = t0 + c;
      const float* qr = sQ + g * hd;
      const float* kr = sK + c * HS;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;  // independent FMA chains
      for (int d = 0; d < hd; d += 4) {
        a0 = fmaf(qr[d], kr[d], a0);
        a1 = fmaf(qr[d + 1], kr[d + 1], a1);
        a2 = fmaf(qr[d + 2], kr[d + 2], a2);
        a3 = fmaf(qr[d + 3], kr[d + 3], a3);
      }
      const float dot = (a0 + a1) + (a2 + a3);
      bool ok = pos < n_valid;
      if (window > 0) {
        int age = ring - pos;
        if (age < 0) age += W;
        ok = ok && age < win_lim;
      }
      sP[i] = ok ? dot * scale : kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NT / 32) {
      const float s = sP[g * TW + lane];
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, repro::warp_max(s));
      const float p = expf(s - m_new);
      const float sum = repro::warp_sum(p);
      sP[g * TW + lane] = repro::round_to<T>(p);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sL[g] = sL[g] * corr + sum;
        sM[g] = m_new;
        sC[g] = corr;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * hd; i += NT) {
      const int g = i / hd, d = i - g * hd;
      const float* pr = sP + g * TW;
      float a = 0.f;
#pragma unroll 8
      for (int c = 0; c < TW; ++c) a = fmaf(pr[c], sV[c * hd + d], a);
      sAcc[i] = sAcc[i] * sC[g] + a;
    }
  }
  __syncthreads();

  T* ob = o + (((size_t)b * S + sq) * H + (size_t)kh * G) * hd;
  for (int i = tid; i < G * hd; i += NT)
    ob[i] = repro::from_f<T>(sAcc[i] / fmaxf(sL[i / hd], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* clen, void* o, int B,
           int S, int W, int K, int G, int hd, int window, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * G * hd + TW * (hd + 1) + TW * hd + G * TW + 3 * G);
  auto kern = decode_fwd<T>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (S < 1) return (int)cudaErrorInvalidValue;
  dim3 grid(K, B, S);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                   static_cast<const T*>(v), clen, static_cast<T*>(o), S,
                                   W, K, G, hd, window, 1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

}  // namespace

// q, o [B, 1, K*G, hd]; caches [B, W, K, hd]; cache_len [B] int32 (device).
// window <= 0: no window. Returns cudaGetLastError() of the launch.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const int* cache_len, void* o, int B, int W, int K,
                                    int G, int hd, int window, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch<float>(q, k, v, cache_len, o, B, 1, W, K, G, hd, window, st);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(q, k, v, cache_len, o, B, 1, W, K, G, hd, window, st);
  return (int)cudaErrorInvalidValue;
}

// Multi-query (verify) form: q, o [B, S, K*G, hd]; query s of row b sits at
// position cache_len[b] + s and sees positions <= its own (no window);
// caches [B, W, K, hd]. Returns cudaGetLastError() of the launch.
extern "C" int spec_decode_attention_fwd(const void* q, const void* k, const void* v,
                                         const int* cache_len, void* o, int B, int S, int W,
                                         int K, int G, int hd, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch<float>(q, k, v, cache_len, o, B, S, W, K, G, hd, 0, st);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(q, k, v, cache_len, o, B, S, W, K, G, hd, 0, st);
  return (int)cudaErrorInvalidValue;
}
