// Decode attention for Hopper (sm_90a): split-K across SMs, one kernel pair
// for the four decode forms of the port (dense or paged cache, one query
// token or S of them).
//
// Replaces
//   * the Pallas TPU kernel src/repro/kernels/decode_attention.py::
//     decode_attention: one query token per row against a dense (ring) cache
//     [B, W, K, hd]; valid slots pos < n_valid = min(cache_len + 1, W) and,
//     with a window, the ring-age mask of its lines 44-50:
//     age = (cache_len % W) - pos (+ W if negative), age < min(window,
//     n_valid + 1);
//   * the Pallas TPU kernel src/repro/kernels/paged_decode_attention.py::
//     paged_decode_attention: the same over pages [P, ps, K, hd] of a shared
//     pool addressed through a block table [B, nw]; position p lives in page
//     bt[b, p / ps], valid positions p < min(cache_len + 1, nw * ps);
//   * in multi-query mode, the XLA spec_attention of the speculative verify
//     step (src/repro/models/attention.py, dense; over the paged_view in
//     src/repro/models/transformer.py; no Pallas kernel): S queries per row,
//     query s at position cache_len[b] + s seeing positions <= its own (no
//     window).
//
// What bounds it on an H100: bytes. A call reads each live K/V row once
// (qwen2.5-3b: 2 KV heads x 128 x 2 bytes, K and V, per position and layer)
// and does ~4·G·hd FLOPs per position, far below the card's ridge of ~295
// FLOP/byte. The card's bandwidth is reached only with many SMs reading at
// once; one block per (KV head, row) put 8 blocks on 132 SMs at 4 slots
// (recurrentgemma-9b's one KV head: 4).
//
// Design (two kernels, no floating-point atomics):
//   * decode_split: grid (split, KV head + K * row, query s). A block takes
//     the SPLIT = 128 slots [sp * SPLIT, (sp + 1) * SPLIT) ∩ [0, n_valid)
//     of its query for the G = H / K query heads that share its KV head
//     (grouped GQA: each K/V row is read once for G heads). Its 8 warps own
//     16 slots each. Paged, the page ids of the split are staged in shared
//     memory with q, so no table lookup sits in front of a K/V load; dense,
//     slot p of row b is cache row (b * W + p) * K + kh. The lanes of a warp
//     split a row into 16-byte loads held in registers (a warp covers
//     32 / lanes-per-row rows per load), batches of loads are issued before
//     their use, and the lane reductions of 8 heads' dot products run side
//     by side. A score is kept where its slot is below n_valid and, with a
//     window, its ring age is below the window's limit; the rest are the
//     reference's NEG_INF. Scores go to shared memory, one warp per head
//     takes the softmax of the split (float32 m, l), the probabilities are
//     rounded to the value type before P·V as in the reference, and each
//     warp's P·V partial is reduced across rows by shuffles and across warps
//     in shared memory in a fixed order. It writes float32 (m, l, acc[hd])
//     partials into scratch the wrapper allocates. A block whose split
//     starts at or past n_valid exits at once, so only live slots are read.
//   * decode_combine: one block per (query head, row, query s) merges the
//     partials of its live splits with the log-sum-exp rescale (the weights
//     e^{m_j - M} once in shared memory, the sums in a fixed order); it
//     computes n_valid itself and reads only live splits.
// A split whose slots the window masks entirely scores NEG_INF everywhere:
// NEG_INF is the finite -1e30, so it writes m = -1e30 with l = SPLIT and a
// finite acc (every p = e^0 = 1). That is harmless only because the combine
// weights split j by e^{m_j - M} and M is finite: the newest slot
// (cache_len % W, age 0) is always kept, so e^{-1e30 - M} = 0.
// Sequence-parallel decode (distributed/collectives.py): a dense cache cut by
// slots into shards at multiples of SPLIT runs the split kernel once per
// shard (split_decode_partials: the shard's splits only, its first slot
// slot0 and its slots per row row_slots; the masks still use the whole
// cache's n_pos) into one scratch, then the combine once
// (split_decode_combine): the same blocks compute the same partials, so the
// result equals the one-launch call bit for bit.
// Split boundaries are absolute slots (multiples of SPLIT), independent of S,
// of the batch and of the other rows, and both kernels depend only on
// (row, cache_len[b] + s): the block of query s computes exactly what a
// one-token call at cache length cache_len[b] + s computes, so the verify
// step equals S decode steps bit for bit, and two calls on the same inputs
// give the same bits.
#include <climits>

#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int SPLIT = 128;  // slots per split (8 pages of 16)
constexpr int NT = 256;     // threads per block
constexpr int NW = NT / 32; // warps
constexpr int PPW = SPLIT / NW;  // warp w owns slots [PPW w, PPW (w + 1)) of the split
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
  static constexpr int STEPS = PPW / RPW;        // steps over a warp's slots
  static constexpr int UNR = (8 / CPL) < STEPS ? (8 / CPL) : STEPS;  // steps per load batch
  static_assert(HD % VN == 0 && 32 % LPR == 0 && PPW % RPW == 0 && STEPS % UNR == 0,
                "plan");
};

// One launch's operands. Dense: bt == nullptr, n_pos = W, ps = nw = 0.
// Paged: n_pos = nw * ps, window = 0.
// slot0 / row_slots: the first slot and the slots per row of the dense cache
// k / v point at (0 and n_pos but for a sequence shard's partials).
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* bt;
  const int* cache_len;
  float* part_acc;
  float* part_ml;
  void* o;
  int B, S, K, G, n_pos, ps, nw, window, nsplit, slot0, row_slots;
};

template <typename T, int HD, bool PAGED>
__global__ void __launch_bounds__(NT)
decode_split(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
             const int* __restrict__ bt, const int* __restrict__ cache_len,
             float* __restrict__ part_acc, float* __restrict__ part_ml, int S, int K, int G,
             int n_pos, int ps, int nw, int window, int nsplit, int slot0, int row_slots,
             float scale) {
  using P = Plan<T, HD>;
  const int sp = blockIdx.x + slot0 / SPLIT, kh = blockIdx.y % K, b = blockIdx.y / K,
            sq = blockIdx.z;
  const int clen = cache_len[b] + sq;
  const int n_valid = min(clen + 1, n_pos);
  const int start = sp * SPLIT;
  if (start >= n_valid) return;  // the combine reads only splits below n_valid
  const int end = min(start + SPLIT, n_valid);
  // the ring's head (the newest token's slot) and the window's age limit;
  // with no window every age passes. The mask below has no branch on the
  // window, and the paged form's is n_valid alone at compile time: a
  // loop-invariant branch there made the compiler keep two copies of the
  // score loop, and the larger code ran 1.4x slower inside a decode step,
  // where the instruction cache is cold.
  const int head = clen % n_pos;
  const int win_lim = window > 0 ? min(window, n_valid + 1) : INT_MAX;

  extern __shared__ float smem[];
  __shared__ int sPage[PAGED ? SPLIT + 1 : 1];  // the pages the split spans
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
  const int page0 = PAGED ? start / ps : 0;
  if constexpr (PAGED) {
    for (int i = tid; i <= (end - 1) / ps - page0; i += NT)
      sPage[i] = bt[(size_t)b * nw + page0 + i];
  }
  __syncthreads();

  const int row = lane / P::LPR, lr = lane % P::LPR;
  // element offset of slot pos's K/V row of head kh
  auto row_off = [&](int pos) -> size_t {
    if constexpr (PAGED)
      return (((size_t)sPage[pos / ps - page0] * ps + pos % ps) * K + kh) * HD;
    else
      return (((size_t)b * row_slots + (pos - slot0)) * K + kh) * HD;
  };
  auto kept = [&](int pos) -> bool {
    if constexpr (PAGED) return pos < end;
    int age = head - pos;
    age += age < 0 ? n_pos : 0;
    return pos < end && age < win_lim;
  };

  // ---- scores: s[g][pos] = q_g · k_pos * scale ------------------------------
  for (int s0 = 0; s0 < P::STEPS; s0 += P::UNR) {
    uint4 raw[P::UNR][P::CPL];
#pragma unroll
    for (int u = 0; u < P::UNR; ++u) {
      const int pos = start + PPW * warp + (s0 + u) * P::RPW + row;
      if (pos < end) {
        const T* kr = kc + row_off(pos);
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
          const bool keep = kept(start + loc);
#pragma unroll
          for (int gg = 0; gg < GT; ++gg)
            if (g0 + gg < G) sS[(g0 + gg) * SPLIT + loc] = keep ? a[gg] * scale : kNegInf;
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
          const T* vr = vc + row_off(pos);
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
decode_combine(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
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
      const float w = expf(ml[2 * j] - m);  // 0 for a split the window masks whole
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

// the split kernel over the row_slots / SPLIT splits from slot0 on
template <typename T, int HD, bool PAGED>
int launch_split(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (a.G * HD + a.G * SPLIT + NW * GT * HD);
  auto split = decode_split<T, HD, PAGED>;
  if (smem > 48 * 1024) {  // above the default: opt in (qwen2.5-3b needs 40 KB)
    const cudaError_t e =
        cudaFuncSetAttribute(split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  split<<<dim3((a.row_slots + SPLIT - 1) / SPLIT, a.K * a.B, a.S), NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.bt, a.cache_len, a.part_acc, a.part_ml, a.S, a.K, a.G, a.n_pos, a.ps, a.nw,
      a.window, a.nsplit, a.slot0, a.row_slots, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_combine(const Args& a, cudaStream_t stream) {
  decode_combine<T, HD><<<dim3(a.K * a.G, a.B, a.S), NT, sizeof(float) * a.nsplit, stream>>>(
      a.part_acc, a.part_ml, a.cache_len, static_cast<T*>(a.o), a.S, a.K * a.G, a.n_pos,
      a.nsplit);
  return (int)cudaGetLastError();
}

enum Stage { kBoth = 0, kPartials = 1, kCombine = 2 };

template <typename T, int HD>
int dispatch_cache(const Args& a, Stage stage, cudaStream_t st) {
  if (stage != kCombine) {
    const int e = a.bt != nullptr ? launch_split<T, HD, true>(a, st)
                                  : launch_split<T, HD, false>(a, st);
    if (e != 0 || stage == kPartials) return e;
  }
  return launch_combine<T, HD>(a, st);
}

template <typename T>
int dispatch_hd(const Args& a, int hd, Stage stage, cudaStream_t st) {
  switch (hd) {
    case 16: return dispatch_cache<T, 16>(a, stage, st);
    case 32: return dispatch_cache<T, 32>(a, stage, st);
    case 64: return dispatch_cache<T, 64>(a, stage, st);
    case 128: return dispatch_cache<T, 128>(a, stage, st);
    case 256: return dispatch_cache<T, 256>(a, stage, st);
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch(const Args& a, int hd, int dtype, Stage stage, cudaStream_t st) {
  if (dtype == repro::kF32) return dispatch_hd<float>(a, hd, stage, st);
  if (dtype == repro::kBF16) return dispatch_hd<__nv_bfloat16>(a, hd, stage, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o [B, S, K*G, hd] (S = 1: one-token decode; S > 1: the verify step);
// cache_len [B] int32 (device). Dense: block_tables == nullptr, caches
// [B, W, K, hd] with n_pos = W, window <= 0 for none (ps, nw unused).
// Paged: pools [P, ps, K, hd], block_tables [B, nw] int32, n_pos = nw * ps,
// no window. Scratch part_acc float [B, S, K, G, nsplit, hd] and part_ml
// float [B, S, K, G, nsplit, 2] with nsplit = ceil(n_pos / SPLIT), as the
// wrapper's split_plan sizes them (its SPLIT and MAX_G are this file's; a CPU
// test holds them equal). Returns cudaGetLastError() of the launches.
extern "C" int split_decode_attention_fwd(
    const void* q, const void* k, const void* v, const int* block_tables,
    const int* cache_len, void* part_acc, void* part_ml, void* o, int B, int S, int K,
    int G, int hd, int n_pos, int ps, int nw, int window, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool paged = block_tables != nullptr;
  if (G < 1 || G > MAX_G || S < 1 || n_pos < 1 || (paged && (window > 0 || n_pos != nw * ps)))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, block_tables, cache_len, static_cast<float*>(part_acc),
               static_cast<float*>(part_ml), o, B, S, K, G, n_pos, ps, nw,
               window > 0 ? window : 0, (n_pos + SPLIT - 1) / SPLIT, 0, n_pos};
  return dispatch(a, hd, dtype, kBoth, st);
}

// Sequence-parallel decode, dense caches only. The partials of one shard:
// k, v [B, row_slots, K, hd] hold slots [slot0, slot0 + row_slots) of a
// cache of n_pos slots a row (slot0 a multiple of SPLIT); its splits'
// (m, l, acc) land at their absolute split index in the scratch of the whole
// cache (nsplit = ceil(n_pos / SPLIT)).
extern "C" int split_decode_partials(
    const void* q, const void* k, const void* v, const int* cache_len, void* part_acc,
    void* part_ml, int B, int S, int K, int G, int hd, int n_pos, int slot0, int row_slots,
    int window, int dtype, void* stream) {
  if (G < 1 || G > MAX_G || S < 1 || n_pos < 1 || row_slots < 1 || slot0 < 0 ||
      slot0 % SPLIT != 0 || slot0 + row_slots > n_pos)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, nullptr, cache_len, static_cast<float*>(part_acc),
               static_cast<float*>(part_ml), nullptr, B, S, K, G, n_pos, 0, 0,
               window > 0 ? window : 0, (n_pos + SPLIT - 1) / SPLIT, slot0, row_slots};
  return dispatch(a, hd, dtype, kPartials, static_cast<cudaStream_t>(stream));
}

// The combine over the partials every shard wrote: o [B, S, K*G, hd].
extern "C" int split_decode_combine(const void* part_acc, const void* part_ml,
                                    const int* cache_len, void* o, int B, int S, int K,
                                    int G, int hd, int n_pos, int dtype, void* stream) {
  if (G < 1 || G > MAX_G || S < 1 || n_pos < 1) return (int)cudaErrorInvalidValue;
  const Args a{nullptr, nullptr, nullptr, nullptr, cache_len,
               static_cast<float*>(const_cast<void*>(part_acc)),
               static_cast<float*>(const_cast<void*>(part_ml)), o, B, S, K, G, n_pos, 0, 0,
               0, (n_pos + SPLIT - 1) / SPLIT, 0, n_pos};
  return dispatch(a, hd, dtype, kCombine, static_cast<cudaStream_t>(stream));
}
