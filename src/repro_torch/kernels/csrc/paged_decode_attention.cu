// Paged decode attention for Hopper (sm_90a): split-K across SMs.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_decode_attention.py::
// paged_decode_attention (one query token per row against pages
// [P, ps, K, hd] of a shared pool addressed through a block table [B, nw];
// position p lives in page bt[b, p / ps], valid positions p < n_valid =
// min(cache_len + 1, nw * ps)), and, in multi-query mode, the XLA
// spec_attention over the JAX package's paged_view
// (src/repro/models/transformer.py, verify mode; no Pallas kernel): S queries
// per row, query s at position cache_len[b] + s seeing positions <= its own.
//
// What bounds it on an H100: bytes. A call reads each live K/V row once
// (qwen2.5-3b: 2 KV heads x 128 x 2 bytes, K and V, per position and layer)
// and does ~4·G·hd FLOPs per position, far below the card's ridge of ~295
// FLOP/byte. The card's bandwidth is reached only with many SMs reading at
// once; one block per (KV head, row), the design this replaces, put 8
// blocks on 132 SMs at 4 slots.
//
// Design (two kernels, no floating-point atomics):
//   * paged_split: grid (split, KV head + K * row, query s). A block takes
//     the SPLIT = 128 positions [sp * SPLIT, (sp + 1) * SPLIT) ∩ [0, n_valid)
//     of its query for the G = H / K query heads that share its KV head
//     (grouped GQA: each K/V row is read once for G heads). Its 8 warps own
//     16 positions each; the page ids of the split are staged in shared
//     memory with q, so no table lookup sits in front of a K/V load; the
//     lanes of a warp split a row into 16-byte
//     loads held in registers (a warp covers 32 / lanes-per-row rows per
//     load), batches of loads are issued before their use, and the lane
//     reductions of 8 heads' dot products run side by side. Scores go to
//     shared memory, one warp per head takes the softmax of the split
//     (float32 m, l), the probabilities are rounded to the value type
//     before P·V as in the reference, and each warp's P·V partial is
//     reduced across rows by shuffles and across warps in shared memory in
//     a fixed order. It writes float32 (m, l, acc[hd]) partials into
//     scratch the wrapper allocates. A block whose split starts at or past
//     n_valid exits at once, so only live pages are read.
//   * paged_combine: one block per (query head, row, query s) merges the
//     partials of its live splits with the log-sum-exp rescale (the weights
//     e^{m_j - M} once in shared memory, the sums in a fixed order); it
//     computes n_valid itself and reads only live splits.
// Split boundaries are absolute positions (multiples of SPLIT), independent
// of S, of the batch and of the other rows, and both kernels depend only on
// (row, cache_len[b] + s): the block of query s computes exactly what a
// one-token call at cache length cache_len[b] + s computes, so the verify
// step equals S decode steps bit for bit, and two calls on the same inputs
// give the same bits.
#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int SPLIT = 128;  // positions per split (8 pages of 16)
constexpr int NT = 256;     // threads per block
constexpr int NW = NT / 32; // warps
constexpr int PPW = SPLIT / NW;  // warp w owns positions [PPW w, PPW (w + 1)) of the split
constexpr int GT = 8;       // query heads per pass of the scores and of P·V (registers)
constexpr int MAX_G = 64;   // shared-memory plan below (sQ: G x hd floats)

// 16-byte loads kept raw in registers until their use
template <typename T> struct Raw;
template <> struct Raw<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void widen(const uint4& r, float* out) {
    out[0] = __uint_as_float(r.x); out[1] = __uint_as_float(r.y);
    out[2] = __uint_as_float(r.z); out[3] = __uint_as_float(r.w);
  }
};
template <> struct Raw<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void widen(const uint4& r, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <typename T, int HD>
struct Plan {
  static constexpr int VN = Raw<T>::N;           // elements per 16-byte load
  static constexpr int CH = HD / VN;             // loads per row
  static constexpr int LPR = CH < 32 ? CH : 32;  // lanes per row
  static constexpr int CPL = CH / LPR;           // loads per lane and row
  static constexpr int RPW = 32 / LPR;           // rows a warp covers per step
  static constexpr int STEPS = PPW / RPW;        // steps over a warp's positions
  static constexpr int UNR = (8 / CPL) < STEPS ? (8 / CPL) : STEPS;  // steps per load batch
  static_assert(HD % VN == 0 && 32 % LPR == 0 && PPW % RPW == 0 && STEPS % UNR == 0,
                "plan");
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
paged_split(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
            const int* __restrict__ bt, const int* __restrict__ cache_len,
            float* __restrict__ part_acc, float* __restrict__ part_ml, int S, int K, int G,
            int ps, int nw, int nsplit, float scale) {
  using P = Plan<T, HD>;
  const int sp = blockIdx.x, kh = blockIdx.y % K, b = blockIdx.y / K, sq = blockIdx.z;
  const int clen = cache_len[b] + sq;
  const int n_valid = min(clen + 1, nw * ps);
  const int start = sp * SPLIT;
  if (start >= n_valid) return;  // the combine reads only splits below n_valid
  const int end = min(start + SPLIT, n_valid);

  extern __shared__ float smem[];
  __shared__ int sPage[SPLIT + 1];   // the pages the split spans
  float* sQ = smem;                  // [G][HD]
  float* sS = sQ + G * HD;           // [G][SPLIT] scores, then rounded probabilities
  float* sRed = sS + G * SPLIT;      // [NW][GT][HD] per-warp P·V partials
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = K * G;

  const T* qb = q + (((size_t)b * S + sq) * H + (size_t)kh * G) * HD;
  for (int i = tid; i < G * P::CH; i += NT) {
    const uint4 r = *reinterpret_cast<const uint4*>(qb + i * P::VN);
    Raw<T>::widen(r, sQ + i * P::VN);
  }
  const int page0 = start / ps;
  for (int i = tid; i <= (end - 1) / ps - page0; i += NT)
    sPage[i] = bt[(size_t)b * nw + page0 + i];
  __syncthreads();

  const int row = lane / P::LPR, lr = lane % P::LPR;
  // element offset of position pos's K/V row of head kh in the pool
  auto row_off = [&](int pos) -> size_t {
    return (((size_t)sPage[pos / ps - page0] * ps + pos % ps) * K + kh) * HD;
  };

  // ---- scores: s[g][pos] = q_g · k_pos * scale ------------------------------
  for (int s0 = 0; s0 < P::STEPS; s0 += P::UNR) {
    uint4 raw[P::UNR][P::CPL];
#pragma unroll
    for (int u = 0; u < P::UNR; ++u) {
      const int pos = start + PPW * warp + (s0 + u) * P::RPW + row;
      if (pos < end) {
        const T* kr = kp + row_off(pos);
#pragma unroll
        for (int c = 0; c < P::CPL; ++c)
          raw[u][c] = *reinterpret_cast<const uint4*>(kr + (lr + c * P::LPR) * P::VN);
      } else {
#pragma unroll
        for (int c = 0; c < P::CPL; ++c) raw[u][c] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    for (int g0 = 0; g0 < G; g0 += GT) {
      // this lane's q columns of GT heads, in registers for the batch
      float qr[GT][P::CPL * P::VN];
#pragma unroll
      for (int gg = 0; gg < GT; ++gg)
#pragma unroll
        for (int c = 0; c < P::CPL; ++c)
#pragma unroll
          for (int e = 0; e < P::VN; ++e)
            qr[gg][c * P::VN + e] =
                g0 + gg < G ? sQ[(g0 + gg) * HD + (lr + c * P::LPR) * P::VN + e] : 0.f;
#pragma unroll
      for (int u = 0; u < P::UNR; ++u) {
        const int loc = PPW * warp + (s0 + u) * P::RPW + row;
        float kx[P::CPL * P::VN];
#pragma unroll
        for (int c = 0; c < P::CPL; ++c) Raw<T>::widen(raw[u][c], kx + c * P::VN);
        // GT heads at once, so their lane reductions are independent
        // shuffles in flight together, not GT dependent chains in a row
        float a[GT];
#pragma unroll
        for (int gg = 0; gg < GT; ++gg) {
          a[gg] = 0.f;
#pragma unroll
          for (int e = 0; e < P::CPL * P::VN; ++e) a[gg] = fmaf(qr[gg][e], kx[e], a[gg]);
        }
#pragma unroll
        for (int o = 1; o < P::LPR; o <<= 1)
#pragma unroll
          for (int gg = 0; gg < GT; ++gg) a[gg] += __shfl_xor_sync(0xffffffffu, a[gg], o);
        if (lr == 0) {
#pragma unroll
          for (int gg = 0; gg < GT; ++gg)
            if (g0 + gg < G)
              sS[(g0 + gg) * SPLIT + loc] = start + loc < end ? a[gg] * scale : kNegInf;
        }
      }
    }
  }
  __syncthreads();

  // ---- softmax of the split, one warp per head ------------------------------
  const size_t part = (((size_t)b * S + sq) * K + kh) * G;  // (row, s, kh, head 0)
  for (int g = warp; g < G; g += NW) {
    float s[SPLIT / 32];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < SPLIT / 32; ++j) {
      s[j] = sS[g * SPLIT + lane + 32 * j];
      mx = fmaxf(mx, s[j]);
    }
    mx = repro::warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < SPLIT / 32; ++j) {
      const float p = expf(s[j] - mx);
      sum += p;
      sS[g * SPLIT + lane + 32 * j] = repro::round_to<T>(p);
    }
    sum = repro::warp_sum(sum);
    if (lane == 0) {
      float* ml = part_ml + ((part + g) * nsplit + sp) * 2;
      ml[0] = mx;
      ml[1] = sum;
    }
  }
  __syncthreads();

  // ---- P·V, GT heads a pass ---------------------------------------------------
  for (int g0 = 0; g0 < G; g0 += GT) {
    float acc[GT][P::CPL * P::VN];
#pragma unroll
    for (int gg = 0; gg < GT; ++gg)
#pragma unroll
      for (int e = 0; e < P::CPL * P::VN; ++e) acc[gg][e] = 0.f;
    for (int s0 = 0; s0 < P::STEPS; s0 += P::UNR) {
      uint4 raw[P::UNR][P::CPL];
#pragma unroll
      for (int u = 0; u < P::UNR; ++u) {
        const int pos = start + PPW * warp + (s0 + u) * P::RPW + row;
        if (pos < end) {
          const T* vr = vp + row_off(pos);
#pragma unroll
          for (int c = 0; c < P::CPL; ++c)
            raw[u][c] = *reinterpret_cast<const uint4*>(vr + (lr + c * P::LPR) * P::VN);
        } else {
#pragma unroll
          for (int c = 0; c < P::CPL; ++c) raw[u][c] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int u = 0; u < P::UNR; ++u) {
        const int loc = PPW * warp + (s0 + u) * P::RPW + row;
        float vx[P::CPL * P::VN];
#pragma unroll
        for (int c = 0; c < P::CPL; ++c) Raw<T>::widen(raw[u][c], vx + c * P::VN);
#pragma unroll
        for (int gg = 0; gg < GT; ++gg) {
          if (g0 + gg < G) {
            const float p = sS[(g0 + gg) * SPLIT + loc];
#pragma unroll
            for (int e = 0; e < P::CPL * P::VN; ++e) acc[gg][e] = fmaf(p, vx[e], acc[gg][e]);
          }
        }
      }
    }
    // the warp's rows hold partials of the same columns: fold them
#pragma unroll
    for (int gg = 0; gg < GT; ++gg)
#pragma unroll
      for (int e = 0; e < P::CPL * P::VN; ++e)
#pragma unroll
        for (int o = P::LPR; o < 32; o <<= 1)
          acc[gg][e] += __shfl_xor_sync(0xffffffffu, acc[gg][e], o);
    if (row == 0) {
#pragma unroll
      for (int gg = 0; gg < GT; ++gg)
#pragma unroll
        for (int c = 0; c < P::CPL; ++c)
#pragma unroll
          for (int e = 0; e < P::VN; ++e)
            sRed[(warp * GT + gg) * HD + (lr + c * P::LPR) * P::VN + e] =
                acc[gg][c * P::VN + e];
    }
    __syncthreads();
    const int ng = min(GT, G - g0);
    for (int i = tid; i < ng * HD; i += NT) {
      const int gg = i / HD, d = i - gg * HD;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) a += sRed[(w * GT + gg) * HD + d];  // fixed order
      part_acc[((part + g0 + gg) * nsplit + sp) * HD + d] = a;
    }
    __syncthreads();
  }
}

// one block per (query head, row, query s):
// o[d] = Σ_j acc_j[d] e^{m_j - M} / Σ_j l_j e^{m_j - M} over the live splits j
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
paged_combine(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
              const int* __restrict__ cache_len, T* __restrict__ o, int S, int H,
              int n_pos, int nsplit) {
  extern __shared__ float sW[];  // [nsplit] e^{m_j - M}
  __shared__ float sL;           // Σ_j l_j e^{m_j - M}
  const int h = blockIdx.x, b = blockIdx.y, sq = blockIdx.z;
  const int n_valid = min(cache_len[b] + sq + 1, n_pos);
  const int nsp = (n_valid + SPLIT - 1) / SPLIT;
  const size_t row = ((size_t)b * S + sq) * H + h;  // (row, s, KV head, head) = o's row
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float* ml = part_ml + row * nsplit * 2;
    float m = kNegInf;
    for (int j = lane; j < nsp; j += 32) m = fmaxf(m, ml[2 * j]);
    m = repro::warp_max(m);
    float l = 0.f;
    for (int j = lane; j < nsp; j += 32) {
      const float w = expf(ml[2 * j] - m);
      sW[j] = w;
      l = fmaf(ml[2 * j + 1], w, l);
    }
    l = repro::warp_sum(l);  // a fixed tree order: the same bits on every call
    if (lane == 0) sL = l;
  }
  __syncthreads();
  const float inv = 1.f / fmaxf(sL, 1e-30f);
  const float* acc = part_acc + row * nsplit * HD;
  for (int d = threadIdx.x; d < HD; d += NT) {
    float a = 0.f;
#pragma unroll 4
    for (int j = 0; j < nsp; ++j) a = fmaf(acc[(size_t)j * HD + d], sW[j], a);
    o[row * HD + d] = repro::from_f<T>(a * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* bt, const int* clen,
           float* part_acc, float* part_ml, void* o, int B, int S, int ps, int K, int G,
           int nw, int nsplit, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (G * HD + G * SPLIT + NW * GT * HD);
  auto split = paged_split<T, HD>;
  cudaError_t e;
  if (smem > 48 * 1024) {  // above the default: opt in (qwen2.5-3b needs 40 KB)
    e = cudaFuncSetAttribute(split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  split<<<dim3(nsplit, K * B, S), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bt,
      clen, part_acc, part_ml, S, K, G, ps, nw, nsplit, 1.0f / sqrtf((float)HD));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_combine<T, HD><<<dim3(K * G, B, S), NT, sizeof(float) * nsplit, stream>>>(
      part_acc, part_ml, clen, static_cast<T*>(o), S, K * G, nw * ps, nsplit);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, const int* bt, const int* clen,
                float* pa, float* pm, void* o, int B, int S, int ps, int K, int G, int hd,
                int nw, int nsplit, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, bt, clen, pa, pm, o, B, S, ps, K, G, nw, nsplit, st);
    case 32: return launch<T, 32>(q, k, v, bt, clen, pa, pm, o, B, S, ps, K, G, nw, nsplit, st);
    case 64: return launch<T, 64>(q, k, v, bt, clen, pa, pm, o, B, S, ps, K, G, nw, nsplit, st);
    case 128: return launch<T, 128>(q, k, v, bt, clen, pa, pm, o, B, S, ps, K, G, nw, nsplit, st);
    case 256: return launch<T, 256>(q, k, v, bt, clen, pa, pm, o, B, S, ps, K, G, nw, nsplit, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o [B, S, K*G, hd] (S = 1: one-token decode; S > 1: the verify step);
// pools [P, ps, K, hd]; block_tables [B, nw] int32; cache_len [B] int32
// (device); scratch part_acc float [B, S, K, G, nsplit, hd] and part_ml
// float [B, S, K, G, nsplit, 2] with nsplit = ceil(nw * ps / SPLIT), as the
// wrapper's split_plan sizes them (its SPLIT and MAX_G are this file's; a CPU
// test holds them equal). Returns cudaGetLastError() of the launches.
extern "C" int paged_split_decode_attention_fwd(
    const void* q, const void* k, const void* v, const int* block_tables,
    const int* cache_len, void* part_acc, void* part_ml, void* o, int B, int S, int ps,
    int K, int G, int hd, int nw, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > MAX_G || S < 1) return (int)cudaErrorInvalidValue;
  const int nsplit = (nw * ps + SPLIT - 1) / SPLIT;
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (dtype == repro::kF32)
    return dispatch_hd<float>(q, k, v, block_tables, cache_len, pa, pm, o, B, S, ps, K, G,
                              hd, nw, nsplit, st);
  if (dtype == repro::kBF16)
    return dispatch_hd<__nv_bfloat16>(q, k, v, block_tables, cache_len, pa, pm, o, B, S,
                                      ps, K, G, hd, nw, nsplit, st);
  return (int)cudaErrorInvalidValue;
}
