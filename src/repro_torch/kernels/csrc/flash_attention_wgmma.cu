// Causal flash attention forward for Hopper (sm_90a) in bf16: tensor cores
// (wgmma) fed by TMA.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention for bf16 inputs (every served model runs bf16; the
// float32 parity path keeps the CUDA-core kernel of flash_attention.cu,
// chosen by dtype at the C entry point flash_attention_fwd, because wgmma
// takes float32 only as TF32, which cannot hold the float32 tolerance of
// 2e-5). Same algorithm as the reference: online softmax over key tiles
// with float32 (m, l, acc), causal mask, optional sliding window, keys at
// positions >= T masked, and the probabilities rounded to bf16 for the P·V
// product while the row sum l is taken over the float32 p
// (flash_attention.py:44-53). As in the CUDA-core kernel: native GQA
// (k, v [B, T, K, hd], query head h reads KV head h / (H / K)) and q_start
// (query row i at position q_start + i, key j at position j).
//
// What bounds it on an H100: operations. At qwen2.5-3b's prefill (S = T =
// 2048, H = 16, hd = 128) the causal work is ~4·hd·H·S²/2 = 17 GFLOP on
// ~20 MB of q/k/v/o; only the tensor cores (989 TFLOP/s bf16) come near
// that bound, which the CUDA-core kernel missed by ~150x.
//
// Design: one warpgroup (128 threads) per (head, 64-query tile, batch row).
//   * S = Q·Kᵀ and O += P·V are wgmma m64nNk16 (bf16 in, float32
//     accumulate): Q and K are K-major operands in shared memory; P is
//     converted to bf16 in registers, where the S accumulator's fragment is
//     already the A-operand fragment of the second product; V is the
//     MN-major (transposed) B operand.
//   * The Q tile and a two-stage ring of K/V tiles (64 keys) arrive by TMA
//     (cp.async.bulk.tensor, 4-D maps over [B, T, K, hd] encoded per call on
//     the host) with mbarrier completion, so the next tile's load overlaps
//     this tile's math. Shared-memory tiles are column blocks of
//     min(hd, 64) bf16 (32-, 64- or 128-byte rows) in the TMA swizzle of
//     the same width, which is the layout the wgmma descriptors name.
//     Positions past T (and query rows past S) are TMA's zero fill.
//   * Key tiles entirely above the causal diagonal (shifted by q_start) or
//     below the window are never loaded; the mask runs only on the tiles
//     that straddle a boundary.
//   * q tiles are launched longest causal row first (grid (H, q tiles, B),
//     the tile index reversed) so the long blocks do not trail.
#include <cstdint>

#include "common.cuh"
#include "tma_tiles.cuh"

namespace {

using namespace repro;

constexpr int BQ = 64;      // query rows per block: one warpgroup's wgmma M
constexpr int BK = 64;      // keys per tile: the N of S = Q·Kᵀ
constexpr int NT = 128;     // one warpgroup
constexpr int STAGES = 2;   // K/V ring depth

// this kernel's tiles (the geometry of a head dim: TileGeo, tma_tiles.cuh)
template <int HD>
struct Geo : TileGeo<HD> {
  static constexpr int Q_BYTES = TileGeo<HD>::NCB * BQ * TileGeo<HD>::ROWB;
  static constexpr int KV_BYTES = TileGeo<HD>::NCB * BK * TileGeo<HD>::ROWB;  // one K (or V)
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * KV_BYTES;
};

template <int HD>
__global__ void __launch_bounds__(NT, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
            float* __restrict__ lse, int S, int Tk, int H, int K, int q_start, int window,
            float scale_log2) {
  using G = Geo<HD>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];  // Q, then the K/V stages
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;  // swizzle period
  const uint32_t sQ = base;
  auto sK = [&](int st) { return base + G::Q_BYTES + st * 2 * G::KV_BYTES; };
  auto sV = [&](int st) { return sK(st) + G::KV_BYTES; };
  const uint32_t bar_q = smem_addr(&bars[0]);
  auto bar_kv = [&](int st) { return smem_addr(&bars[1 + st]); };

  const int h = blockIdx.x, qb = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = qb * BQ, nq = min(BQ, S - q0);
  const int k_end = min(Tk, q_start + q0 + nq);  // causal: keys <= the tile's last query
  int k_beg = window > 0 ? max(0, q_start + q0 - window + 1) : 0;
  k_beg = (k_beg / BK) * BK;
  const int n_tiles = k_end > k_beg ? (k_end - k_beg + BK - 1) / BK : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  auto load_kv = [&](int t) {  // thread 0 only
    const int st = t % STAGES, k0 = k_beg + t * BK;
    mbar_expect_tx(bar_kv(st), 2 * G::KV_BYTES);
#pragma unroll
    for (int cb = 0; cb < G::NCB; ++cb) {
      tma_load_4d(sK(st) + cb * BK * G::ROWB, &tk, bar_kv(st), cb * G::BC, kh, k0, b);
      tma_load_4d(sV(st) + cb * BK * G::ROWB, &tv, bar_kv(st), cb * G::BC, kh, k0, b);
    }
  };
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < STAGES; ++st) mbar_init(bar_kv(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, G::Q_BYTES);
#pragma unroll
    for (int cb = 0; cb < G::NCB; ++cb)
      tma_load_4d(sQ + cb * BQ * G::ROWB, &tq, bar_q, cb * G::BC, h, q0, b);
    for (int t = 0; t < STAGES && t < n_tiles; ++t) load_kv(t);
  }

  // this thread's accumulator rows: r0 and r0 + 8 of the tile
  const int r0 = warp * 16 + (lane >> 2);
  const int qpos0 = q_start + q0 + r0, qpos1 = qpos0 + 8;
  float oacc[G::NCB][G::BC / 2];
#pragma unroll
  for (int cb = 0; cb < G::NCB; ++cb)
#pragma unroll
    for (int i = 0; i < G::BC / 2; ++i) oacc[cb][i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  float sacc[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;

  mbar_wait(bar_q, 0);
  __syncwarp();
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES, k0 = k_beg + t * BK;
    mbar_wait(bar_kv(st), (t / STAGES) & 1);
    __syncwarp();  // wgmma is .aligned: the warp reconverges after the wait

    // ---- S = Q·Kᵀ -------------------------------------------------------------
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(sacc, desc_kmajor<HD>(sQ, BQ, kk), desc_kmajor<HD>(sK(st), BK, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);

    // ---- mask (boundary tiles only) and online softmax, log2 domain -------------
    const bool need_mask = k0 + BK - 1 > q_start + q0 || k0 + BK > Tk ||
                           (window > 0 && k0 < q_start + q0 + BQ - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float s = sacc[i] * scale_log2;
      if (need_mask) {
        const int kpos = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int qpos = (i & 2) ? qpos1 : qpos0;
        const bool ok = kpos < Tk && kpos <= qpos && (window <= 0 || qpos - kpos < window);
        s = ok ? s : kNegInf;
      }
      sacc[i] = s;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row lives in the 4 lanes of a quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      corr[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
    uint32_t pa[BK / 16][4];  // P in bf16: the A fragments of O += P·V
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const int r = (i >> 1) & 1;
      const float p0 = exp2f(sacc[i] - m_r[r]), p1 = exp2f(sacc[i + 1] - m_r[r]);
      sum[r] += p0 + p1;
      pa[i >> 3][(i >> 1) & 3] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_r[r] = l_r[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int cb = 0; cb < G::NCB; ++cb)
#pragma unroll
      for (int i = 0; i < G::BC / 2; ++i) oacc[cb][i] *= corr[(i >> 1) & 1];

    // ---- O += P·V --------------------------------------------------------------
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int cb = 0; cb < G::NCB; ++cb)
        wgmma_rs<G::BC>(oacc[cb], pa[kk], desc_mnmajor<HD>(sV(st), BK, cb, kk));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int cb = 0; cb < G::NCB; ++cb) fence_regs(oacc[cb]);

    __syncthreads();  // every warp is done with stage st: refill it
    if (tid == 0 && t + STAGES < n_tiles) load_kv(t + STAGES);
  }

  // the rows' log-sum-exp of the scaled scores (natural log), for the backward
  if (lse != nullptr && (lane & 3) == 0) {
    float* lrow = lse + (size_t)(b * H + h) * S + q0 + r0;
    if (r0 < nq) lrow[0] = (m_r[0] + log2f(l_r[0])) * 0.6931471805599453f;
    if (r0 + 8 < nq) lrow[8] = (m_r[1] + log2f(l_r[1])) * 0.6931471805599453f;
  }
  const float inv0 = 1.f / fmaxf(l_r[0], 1e-30f), inv1 = 1.f / fmaxf(l_r[1], 1e-30f);
  const size_t row_stride = (size_t)H * HD;
  __nv_bfloat16* o0 = o + ((size_t)(b * S + q0 + r0) * H + h) * HD;
  __nv_bfloat16* o1 = o0 + 8 * row_stride;
#pragma unroll
  for (int cb = 0; cb < G::NCB; ++cb)
#pragma unroll
    for (int j = 0; j < G::BC / 8; ++j) {
      const int col = cb * G::BC + 8 * j + 2 * (lane & 3);
      if (r0 < nq)
        *reinterpret_cast<uint32_t*>(o0 + col) =
            pack_bf16(oacc[cb][4 * j] * inv0, oacc[cb][4 * j + 1] * inv0);
      if (r0 + 8 < nq)
        *reinterpret_cast<uint32_t*>(o1 + col) =
            pack_bf16(oacc[cb][4 * j + 2] * inv1, oacc[cb][4 * j + 3] * inv1);
    }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
           int Tk, int H, int K, int q_start, int window, cudaStream_t stream) {
  using G = Geo<HD>;
  CUtensorMap tq, tk, tv;
  if (!tile_map<HD>(&tq, q, B, S, H) || !tile_map<HD>(&tk, k, B, Tk, K) ||
      !tile_map<HD>(&tv, v, B, Tk, K))
    return (int)cudaErrorInvalidValue;
  const int smem = G::SMEM + 1024;  // + room to align the tiles to the swizzle period
  auto kern = flash_wgmma<HD>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)HD);
  kern<<<dim3(H, (S + BQ - 1) / BQ, B), NT, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, S, Tk, H, K, q_start, window,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

namespace repro {

// the bf16 route of flash_attention_fwd (flash_attention.cu): q, o
// [B, S, H, hd]; k, v [B, T, K, hd]; contiguous, 16-byte aligned, T >= 1;
// lse (float32 [B, H, S]) written when not null
int flash_attention_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                          int B, int S, int T, int H, int K, int hd, int q_start, int window,
                          cudaStream_t st) {
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, lse, B, S, T, H, K, q_start, window, st);
    case 32: return launch<32>(q, k, v, o, lse, B, S, T, H, K, q_start, window, st);
    case 64: return launch<64>(q, k, v, o, lse, B, S, T, H, K, q_start, window, st);
    case 128: return launch<128>(q, k, v, o, lse, B, S, T, H, K, q_start, window, st);
    case 256: return launch<256>(q, k, v, o, lse, B, S, T, H, K, q_start, window, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro
