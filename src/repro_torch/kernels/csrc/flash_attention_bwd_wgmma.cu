// Causal flash attention backward for Hopper (sm_90a) in bf16: tensor cores
// (wgmma) fed by TMA.
//
// Replaces the gradient of the Pallas TPU kernel src/repro/kernels/
// flash_attention.py::flash_attention for bf16 inputs. The reference has no
// backward kernel (its Pallas kernels have no VJP): it trains on XLA's
// autodiff of src/repro/models/attention.py::flash_attention. Same contract
// as the plain version (kernels/flash_attention.py::flash_attention_bwd):
// native GQA (query head h reads KV head h / G), causal in positions (query
// row i at q_start + i, key j at j), an optional sliding window, the
// probabilities rounded to bf16 before Pᵀ·dO as in the forward's P·V,
// float32 accumulation, dq / dk / dv in bf16. The float32 route, the kernels
// both routes share (delta) and the C entry flash_attention_bwd are in
// flash_attention_bwd.cu.
//
// What bounds it on an H100: operations. Five products over the causal pairs
// (Q·Kᵀ and dO·Vᵀ recomputed, Pᵀ·dO, dSᵀ·Q, dS·K): at qwen2.5-3b's train
// microbatch ([2, 2048, 16, 128]) 10·hd·H·pairs·B = 86 GFLOP against ~50 MB
// of inputs and outputs, 0.087 ms at the bf16 tensor-core rate. Only wgmma
// comes near that.
//
// Design: FA2's backward, made deterministic (no atomics: every sum has one
// order, so two calls on the same inputs give the same bits; a resumed
// training run repeats the uninterrupted one bit for bit).
//   * dK / dV: a block (one warpgroup) per (64-key tile, KV head, batch
//     row, split of the G query heads). K and V stay in shared memory; the
//     block walks every query tile that can see a key of its tile, for each
//     of its query heads (GQA: the G heads of a KV head are summed inside
//     the block, in head order). Each step computes Sᵀ = K·Qᵀ and
//     dPᵀ = V·dOᵀ with the keys as wgmma's 64 rows (the Q and dO tiles are
//     K-major B operands), Pᵀ = exp(Sᵀ − lse) and dSᵀ = Pᵀ∘(dPᵀ − delta) in
//     registers, then dV += Pᵀ·dO and dK += dSᵀ·Q with Pᵀ and dSᵀ converted
//     to bf16 in registers as the A operand (the accumulator fragment of the
//     first products is the A fragment of the second, as in the forward's
//     P·V) and the same Q and dO tiles as MN-major B operands. Q and dO
//     arrive by TMA in a 2-stage mbarrier ring; each stage's 64 lse and
//     delta values are staged in shared memory by plain loads.
//   * Filling 132 SMs: at qwen's microbatch a (key tile, KV head, row) grid
//     is 128 blocks and the causal walk is uneven (key tile 0 sees every
//     query tile, the last one). The wrapper splits the G heads over up to
//     4 blocks (flash_attention.bwd_splits); each writes float32 partial
//     dK / dV, and flash_bwd_sum adds them in split order. Key tile 0, the
//     longest, is launched first.
//   * Head dim 256: float32 dK and dV accumulators of 64 keys x 256 columns
//     would take 256 registers a thread of one warpgroup. So at hd 256 dV
//     and dK are computed by separate launches of the same kernel (PASS):
//     the dV pass needs only Sᵀ and Pᵀ·dO, the dK pass Sᵀ, dPᵀ and dSᵀ·Q.
//     Shared memory holds K, V and two stages of Q and dO: 192 KB.
//   * dQ: a block per (64-query tile, head, batch row), launched longest
//     causal row first, walks the visible key tiles (2-stage TMA ring of K
//     and V), recomputes S and dP and accumulates dQ += dS·K in float32
//     registers (K as the MN-major B operand). 7 products in all instead of
//     FA2's 5, in place of float32 atomics on dQ, which would sum in another
//     order on every run.
//   * Tiles entirely above the causal diagonal (shifted by q_start) or below
//     the window are never visited; the mask runs only on the tiles that
//     straddle a boundary. Query rows past S get lse = +inf (P = 0); key
//     rows past T are masked in dQ and never stored in dK / dV.
#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "tma_tiles.cuh"

namespace {

using namespace repro;

constexpr int BR = 64;      // rows of every tile: one warpgroup's wgmma M
constexpr int NT = 128;     // one warpgroup
constexpr int STAGES = 2;   // ring depth
constexpr float LOG2E = 1.4426950408889634f;

enum Pass { kBoth = 0, kDV = 1, kDK = 2 };

template <int HD>
struct BwdGeo : TileGeo<HD> {
  static constexpr int TILE = TileGeo<HD>::TILE64;
  // two resident tiles (K, V or Q, dO) and a ring of two-tile stages
  static constexpr int SMEM = 2 * TILE + STAGES * 2 * TILE;
};

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------

template <int HD, int PASS>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkdv(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               float* __restrict__ part, int B, int S, int Tk, int H, int K, int nsplit,
               int q_start, int window, float scale_log2, float scale) {
  using G = BwdGeo<HD>;
  constexpr bool DO_DV = PASS != kDK, DO_DK = PASS != kDV;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];  // K / V, then the Q / dO stages
  __shared__ float sL[STAGES][BR], sDl[STAGES][BR];   // lse·log2(e) and delta of a stage
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;  // swizzle period
  const uint32_t sK = base, sV = base + G::TILE;
  auto sQ = [&](int st) { return base + (2 + 2 * st) * G::TILE; };
  auto sO = [&](int st) { return sQ(st) + G::TILE; };  // dO
  const uint32_t bar_kv = smem_addr(&bars[0]);
  auto bar_st = [&](int st) { return smem_addr(&bars[1 + st]); };

  const int x = blockIdx.x;  // (batch row, KV head, split) with the split fastest
  const int split = x % nsplit, kh = (x / nsplit) % K, b = x / (nsplit * K);
  const int k0 = blockIdx.y * BR;  // key tile 0, the longest walk, first
  const int Gq = H / K, gs = Gq / nsplit, h0 = kh * Gq + split * gs;
  // the query rows that some key of the tile sees: [lo, hi)
  const int lo = max(0, k0 - q_start);
  const int hi = window > 0 ? min(S, k0 + BR - 1 + window - q_start) : S;
  const int qt0 = lo / BR, n_qt = hi > lo ? (hi + BR - 1) / BR - qt0 : 0;
  const int n_steps = gs * n_qt;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  auto head_of = [&](int t) { return h0 + t / n_qt; };
  auto q0_of = [&](int t) { return (qt0 + t % n_qt) * BR; };
  auto load_rows = [&](int t) {  // threads 0..63: step t's lse and delta
    const int st = t % STAGES, qi = q0_of(t) + tid;
    const size_t at = ((size_t)b * H + head_of(t)) * S + qi;
    sL[st][tid] = qi < S ? lse[at] * LOG2E : INFINITY;  // rows past S: P = 0
    sDl[st][tid] = qi < S ? delta[at] : 0.f;
  };
  auto load_tiles = [&](int t) {  // thread 0 only
    const int st = t % STAGES, h = head_of(t), q0 = q0_of(t);
    mbar_expect_tx(bar_st(st), 2 * G::TILE);
#pragma unroll
    for (int cb = 0; cb < G::NCB; ++cb) {
      tma_load_4d(sQ(st) + cb * BR * G::ROWB, &tq, bar_st(st), cb * G::BC, h, q0, b);
      tma_load_4d(sO(st) + cb * BR * G::ROWB, &tdo, bar_st(st), cb * G::BC, h, q0, b);
    }
  };
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < STAGES; ++st) mbar_init(bar_st(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (tid < BR)
    for (int t = 0; t < STAGES && t < n_steps; ++t) load_rows(t);
  __syncthreads();
  if (tid == 0 && n_steps > 0) {
    mbar_expect_tx(bar_kv, 2 * G::TILE);
#pragma unroll
    for (int cb = 0; cb < G::NCB; ++cb) {
      tma_load_4d(sK + cb * BR * G::ROWB, &tk, bar_kv, cb * G::BC, kh, k0, b);
      tma_load_4d(sV + cb * BR * G::ROWB, &tv, bar_kv, cb * G::BC, kh, k0, b);
    }
    for (int t = 0; t < STAGES && t < n_steps; ++t) load_tiles(t);
  }

  // this thread's accumulator rows: keys r0 and r0 + 8 of the tile
  const int r0 = warp * 16 + (lane >> 2);
  const int kpos0 = k0 + r0, kpos1 = kpos0 + 8;
  float dva[G::NCB][G::BC / 2], dka[G::NCB][G::BC / 2];
#pragma unroll
  for (int cb = 0; cb < G::NCB; ++cb)
#pragma unroll
    for (int i = 0; i < G::BC / 2; ++i) dva[cb][i] = dka[cb][i] = 0.f;
  float sacc[BR / 2], dpacc[BR / 2];
#pragma unroll
  for (int i = 0; i < BR / 2; ++i) sacc[i] = dpacc[i] = 0.f;

  if (n_steps > 0) mbar_wait(bar_kv, 0);
  __syncwarp();
  for (int t = 0; t < n_steps; ++t) {
    const int st = t % STAGES, q0 = q0_of(t);
    mbar_wait(bar_st(st), (t / STAGES) & 1);
    __syncwarp();  // wgmma is .aligned: the warp reconverges after the wait

    // ---- Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ (keys as rows) -------------------------------
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(sacc, desc_kmajor<HD>(sK, BR, kk), desc_kmajor<HD>(sQ(st), BR, kk), kk > 0);
    if constexpr (DO_DK) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(dpacc, desc_kmajor<HD>(sV, BR, kk), desc_kmajor<HD>(sO(st), BR, kk),
                     kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);
    if constexpr (DO_DK) fence_regs(dpacc);

    // ---- Pᵀ, dSᵀ in registers; bf16 A fragments ------------------------------
    const bool need_mask = k0 + BR - 1 > q_start + q0 ||
                           (window > 0 && q_start + q0 + BR - 1 - k0 >= window);
    uint32_t pa[BR / 16][4], sa[BR / 16][4];
#pragma unroll
    for (int i = 0; i < BR / 2; i += 2) {
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = i + e;
        const int c = 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);  // query column
        float pv = exp2f(sacc[j] * scale_log2 - sL[st][c]);
        if (need_mask) {
          const int kpos = (j & 2) ? kpos1 : kpos0, qpos = q_start + q0 + c;
          const bool ok = kpos <= qpos && (window <= 0 || qpos - kpos < window);
          pv = ok ? pv : 0.f;
        }
        p[e] = pv;
        if constexpr (DO_DK) ds[e] = pv * (dpacc[j] - sDl[st][c]);
      }
      if constexpr (DO_DV) pa[i >> 3][(i >> 1) & 3] = pack_bf16(p[0], p[1]);
      if constexpr (DO_DK) sa[i >> 3][(i >> 1) & 3] = pack_bf16(ds[0], ds[1]);
    }

    // ---- dV += Pᵀ·dO, dK += dSᵀ·Q ---------------------------------------------
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk)
#pragma unroll
      for (int cb = 0; cb < G::NCB; ++cb) {
        if constexpr (DO_DV)
          wgmma_rs<G::BC>(dva[cb], pa[kk], desc_mnmajor<HD>(sO(st), BR, cb, kk));
        if constexpr (DO_DK)
          wgmma_rs<G::BC>(dka[cb], sa[kk], desc_mnmajor<HD>(sQ(st), BR, cb, kk));
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int cb = 0; cb < G::NCB; ++cb) {
      if constexpr (DO_DV) fence_regs(dva[cb]);
      if constexpr (DO_DK) fence_regs(dka[cb]);
    }

    __syncthreads();  // every warp is done with stage st: refill it
    if (t + STAGES < n_steps) {
      if (tid == 0) load_tiles(t + STAGES);
      if (tid < BR) load_rows(t + STAGES);
    }
  }

  // ---- store: bf16 when one split, else this split's float32 partial -------
  const size_t n = (size_t)B * Tk * K * HD;
  auto store = [&](float (&acc)[G::NCB][G::BC / 2], __nv_bfloat16* out, int which,
                   float mul) {
#pragma unroll
    for (int cb = 0; cb < G::NCB; ++cb)
#pragma unroll
      for (int j = 0; j < G::BC / 8; ++j) {
        const int col = cb * G::BC + 8 * j + 2 * (lane & 3);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int kp = half ? kpos1 : kpos0;
          if (kp >= Tk) continue;
          const float a0 = acc[cb][4 * j + 2 * half] * mul;
          const float a1 = acc[cb][4 * j + 2 * half + 1] * mul;
          const size_t at = ((size_t)(b * Tk + kp) * K + kh) * HD + col;
          if (nsplit == 1)
            *reinterpret_cast<uint32_t*>(out + at) = pack_bf16(a0, a1);
          else
            *reinterpret_cast<float2*>(part + ((size_t)which * nsplit + split) * n + at) =
                make_float2(a0, a1);
        }
      }
  };
  if constexpr (DO_DK) store(dka, dk, 0, scale);
  if constexpr (DO_DV) store(dva, dv, 1, 1.f);
}

// dk, dv = the float32 partials of the splits, added in split order
__global__ void flash_bwd_sum(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, size_t n, int nsplit) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < 2 * n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int which = i >= n;
    const size_t at = i - which * n;
    const float* p = part + (size_t)which * nsplit * n + at;
    float a = 0.f;
    for (int s = 0; s < nsplit; ++s) a += p[(size_t)s * n];
    (which ? dv : dk)[at] = __float2bfloat16(a);
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int S, int Tk, int H, int K, int q_start,
             int window, float scale_log2, float scale) {
  using G = BwdGeo<HD>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];  // Q / dO, then the K / V stages
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sO = base + G::TILE;
  auto sK = [&](int st) { return base + (2 + 2 * st) * G::TILE; };
  auto sV = [&](int st) { return sK(st) + G::TILE; };
  const uint32_t bar_q = smem_addr(&bars[0]);
  auto bar_kv = [&](int st) { return smem_addr(&bars[1 + st]); };

  const int h = blockIdx.x, qb = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = qb * BR, nq = min(BR, S - q0);
  const int k_end = min(Tk, q_start + q0 + nq);  // causal: keys <= the tile's last query
  int k_beg = window > 0 ? max(0, q_start + q0 - window + 1) : 0;
  k_beg = (k_beg / BR) * BR;
  const int n_tiles = k_end > k_beg ? (k_end - k_beg + BR - 1) / BR : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  auto load_kv = [&](int t) {  // thread 0 only
    const int st = t % STAGES, k0 = k_beg + t * BR;
    mbar_expect_tx(bar_kv(st), 2 * G::TILE);
#pragma unroll
    for (int cb = 0; cb < G::NCB; ++cb) {
      tma_load_4d(sK(st) + cb * BR * G::ROWB, &tk, bar_kv(st), cb * G::BC, kh, k0, b);
      tma_load_4d(sV(st) + cb * BR * G::ROWB, &tv, bar_kv(st), cb * G::BC, kh, k0, b);
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
    mbar_expect_tx(bar_q, 2 * G::TILE);
#pragma unroll
    for (int cb = 0; cb < G::NCB; ++cb) {
      tma_load_4d(sQ + cb * BR * G::ROWB, &tq, bar_q, cb * G::BC, h, q0, b);
      tma_load_4d(sO + cb * BR * G::ROWB, &tdo, bar_q, cb * G::BC, h, q0, b);
    }
    for (int t = 0; t < STAGES && t < n_tiles; ++t) load_kv(t);
  }

  // this thread's rows: r0 and r0 + 8 of the tile
  const int r0 = warp * 16 + (lane >> 2);
  const int qpos0 = q_start + q0 + r0, qpos1 = qpos0 + 8;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + 8 * r;
    const size_t at = ((size_t)b * H + h) * S + qi;
    lse2[r] = qi < S ? lse[at] * LOG2E : INFINITY;
    dl[r] = qi < S ? delta[at] : 0.f;
  }
  float dqa[G::NCB][G::BC / 2];
#pragma unroll
  for (int cb = 0; cb < G::NCB; ++cb)
#pragma unroll
    for (int i = 0; i < G::BC / 2; ++i) dqa[cb][i] = 0.f;
  float sacc[BR / 2], dpacc[BR / 2];
#pragma unroll
  for (int i = 0; i < BR / 2; ++i) sacc[i] = dpacc[i] = 0.f;

  mbar_wait(bar_q, 0);
  __syncwarp();
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES, k0 = k_beg + t * BR;
    mbar_wait(bar_kv(st), (t / STAGES) & 1);
    __syncwarp();

    // ---- S = Q·Kᵀ, dP = dO·Vᵀ ----------------------------------------------------
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(sacc, desc_kmajor<HD>(sQ, BR, kk), desc_kmajor<HD>(sK(st), BR, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(dpacc, desc_kmajor<HD>(sO, BR, kk), desc_kmajor<HD>(sV(st), BR, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);
    fence_regs(dpacc);

    // ---- dS = P∘(dP − delta) in bf16 A fragments (boundary tiles masked) --------
    const bool need_mask = k0 + BR - 1 > q_start + q0 || k0 + BR > Tk ||
                           (window > 0 && k0 < q_start + q0 + BR - window);
    uint32_t sa[BR / 16][4];
#pragma unroll
    for (int i = 0; i < BR / 2; i += 2) {
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = i + e, r = (j >> 1) & 1;
        float p = exp2f(sacc[j] * scale_log2 - lse2[r]);
        if (need_mask) {
          const int kpos = k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
          const int qpos = r ? qpos1 : qpos0;
          const bool ok = kpos < Tk && kpos <= qpos && (window <= 0 || qpos - kpos < window);
          p = ok ? p : 0.f;
        }
        ds[e] = p * (dpacc[j] - dl[r]);
      }
      sa[i >> 3][(i >> 1) & 3] = pack_bf16(ds[0], ds[1]);
    }

    // ---- dQ += dS·K ----------------------------------------------------------------
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk)
#pragma unroll
      for (int cb = 0; cb < G::NCB; ++cb)
        wgmma_rs<G::BC>(dqa[cb], sa[kk], desc_mnmajor<HD>(sK(st), BR, cb, kk));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int cb = 0; cb < G::NCB; ++cb) fence_regs(dqa[cb]);

    __syncthreads();  // every warp is done with stage st: refill it
    if (tid == 0 && t + STAGES < n_tiles) load_kv(t + STAGES);
  }

  const size_t row_stride = (size_t)H * HD;
  __nv_bfloat16* d0 = dq + ((size_t)(b * S + q0 + r0) * H + h) * HD;
  __nv_bfloat16* d1 = d0 + 8 * row_stride;
#pragma unroll
  for (int cb = 0; cb < G::NCB; ++cb)
#pragma unroll
    for (int j = 0; j < G::BC / 8; ++j) {
      const int col = cb * G::BC + 8 * j + 2 * (lane & 3);
      if (r0 < nq)
        *reinterpret_cast<uint32_t*>(d0 + col) =
            pack_bf16(dqa[cb][4 * j] * scale, dqa[cb][4 * j + 1] * scale);
      if (r0 + 8 < nq)
        *reinterpret_cast<uint32_t*>(d1 + col) =
            pack_bf16(dqa[cb][4 * j + 2] * scale, dqa[cb][4 * j + 3] * scale);
    }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

template <typename Kern>
cudaError_t allow_smem(Kern kern, int smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int HD, int PASS>
int launch_dkdv(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                const CUtensorMap& tdo, const float* lse, const float* delta, void* dk,
                void* dv, float* part, int B, int S, int Tk, int H, int K, int nsplit,
                int q_start, int window, float scale_log2, float scale, cudaStream_t st) {
  const int smem = BwdGeo<HD>::SMEM + 1024;  // + room to align to the swizzle period
  auto kern = flash_bwd_dkdv<HD, PASS>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(B * K * nsplit, (Tk + BR - 1) / BR), NT, smem, st>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), part, B, S, Tk, H, K, nsplit, q_start, window,
      scale_log2, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dq, void* dk, void* dv, float* part, int B, int S,
           int Tk, int H, int K, int q_start, int window, int nsplit, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo;
  if (!tile_map<HD>(&tq, q, B, S, H) || !tile_map<HD>(&tk, k, B, Tk, K) ||
      !tile_map<HD>(&tv, v, B, Tk, K) || !tile_map<HD>(&tdo, dout, B, S, H))
    return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)HD), scale_log2 = LOG2E * scale;
  int err;
  if constexpr (HD == 256) {  // dV and dK in separate passes (registers)
    err = launch_dkdv<HD, kDV>(tq, tk, tv, tdo, lse, delta, dk, dv, part, B, S, Tk, H, K,
                               nsplit, q_start, window, scale_log2, scale, st);
    if (err == 0)
      err = launch_dkdv<HD, kDK>(tq, tk, tv, tdo, lse, delta, dk, dv, part, B, S, Tk, H, K,
                                 nsplit, q_start, window, scale_log2, scale, st);
  } else {
    err = launch_dkdv<HD, kBoth>(tq, tk, tv, tdo, lse, delta, dk, dv, part, B, S, Tk, H, K,
                                 nsplit, q_start, window, scale_log2, scale, st);
  }
  if (err != 0) return err;
  if (nsplit > 1) {
    const size_t n = (size_t)B * Tk * K * HD;
    const int blocks = (int)std::min<size_t>((2 * n + 255) / 256, 132 * 16);
    flash_bwd_sum<<<blocks, 256, 0, st>>>(part, static_cast<__nv_bfloat16*>(dk),
                                          static_cast<__nv_bfloat16*>(dv), n, nsplit);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int smem = BwdGeo<HD>::SMEM + 1024;
  auto kern = flash_bwd_dq<HD>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(H, (S + BR - 1) / BR, B), NT, smem, st>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dq), S, Tk, H, K, q_start,
      window, scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace

namespace repro {

// the bf16 route of flash_attention_bwd (flash_attention_bwd.cu), after its
// delta kernel: q, dout, dq [B, S, H, hd]; k, v, dk, dv [B, T, K, hd]; lse,
// delta float32 [B, H, S]; part: float32 [2, nsplit, B, T, K, hd] when
// nsplit > 1 (the G = H / K query heads of a KV head in nsplit splits)
int flash_attention_bwd_wgmma(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, void* dq, void* dk,
                              void* dv, float* part, int B, int S, int T, int H, int K,
                              int hd, int q_start, int window, int nsplit, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<16>(q, k, v, dout, lse, delta, dq, dk, dv, part, B, S, T, H, K,
                               q_start, window, nsplit, st);
    case 32: return launch<32>(q, k, v, dout, lse, delta, dq, dk, dv, part, B, S, T, H, K,
                               q_start, window, nsplit, st);
    case 64: return launch<64>(q, k, v, dout, lse, delta, dq, dk, dv, part, B, S, T, H, K,
                               q_start, window, nsplit, st);
    case 128: return launch<128>(q, k, v, dout, lse, delta, dq, dk, dv, part, B, S, T, H, K,
                                 q_start, window, nsplit, st);
    case 256: return launch<256>(q, k, v, dout, lse, delta, dq, dk, dv, part, B, S, T, H, K,
                                 q_start, window, nsplit, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro
