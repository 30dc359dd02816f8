// Causal flash attention backward for Hopper (sm_90a) in bf16: tensor cores
// (wgmma) fed by TMA, warp-specialised.
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
// comes near that, and only when the tensor cores never wait on the loads
// or on the softmax arithmetic between the products.
//
// Design. Deterministic: no atomics on values, every sum has one order, so
// two calls on the same inputs give the same bits and a resumed training run
// repeats the uninterrupted one bit for bit.
//   * dK / dV (flash_bwd_dkdv): a block per (64-key tile, KV head, batch
//     row, split of the G query heads). K and V stay in shared memory; the
//     block walks every 64-query tile that can see a key of its tile, for
//     each of its query heads (GQA: the G heads of a KV head are summed in
//     the block, in head order). A step computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
//     with the keys as wgmma's 64 rows (Q, dO K-major B operands),
//     Pᵀ = exp2(Sᵀ·scale·log2 e − lse·log2 e) and dSᵀ = Pᵀ∘(dPᵀ − delta) in
//     registers, then dV += Pᵀ·dO and dK += dSᵀ·Q with Pᵀ and dSᵀ in bf16
//     as register A fragments (the accumulator fragment of the first
//     products is the A fragment of the second) and Q, dO as MN-major B
//     operands.
//     - hd <= WIDE_HD (128): one warpgroup a block, two blocks an SM (96 KB
//       of shared memory, 240 registers a thread at hd 128). Sᵀ and dPᵀ go
//       out as two wgmma groups: Pᵀ is computed while dPᵀ runs
//       (wgmma_wait<1>), and dV += Pᵀ·dO runs while dSᵀ is formed.
//     - hd 256: two warpgroups share the 64 keys. Warpgroup 0 computes Sᵀ
//       and Pᵀ, warpgroup 1 dPᵀ, which it hands over in shared memory (XBUF,
//       16 KB: thread t's fragment value i at word 128 i + t, no bank
//       conflicts); warpgroup 0 forms dSᵀ and hands the bf16 Pᵀ and dSᵀ
//       fragments back in the same 16 KB (named barriers BAR_DP,
//       BAR_FRAG); each warpgroup then sums 128 of the 256 columns of dV
//       and dK (128 accumulator registers a thread), so dV and dK take one
//       pass over the pairs. 208 KB of shared memory, one block an SM.
//     - The ring of KV_STAGES Q / dO stages has no producer warp: the last
//       of the block's warps to be done with a stage (a shared counter)
//       refills it, Q and dO by TMA, lse and delta by cp.async, all
//       completing the stage's one mbarrier, so nothing waits on a load
//       behind a block-wide barrier. A producer warp costs registers the
//       accumulators need: a ninth warp puts three warps on one SM
//       sub-partition (168 registers a thread), and setmaxnreg 24 / 240
//       with a producer warpgroup left ptxas allocating the consumers at
//       most ~187 registers: dK / dV spilled and every wgmma was serialised.
//   * dQ (flash_bwd_dq): a block per (query tile, head, batch row), launched
//     longest causal row first, walks the visible 64-key tiles, recomputes S
//     and dP and accumulates dQ += dS·K in float32 registers (K as the
//     MN-major B operand). Two consumer warpgroups and a producer
//     warpgroup (setmaxnreg: PRODUCER_REGS / CONSUMER_REGS), one of whose
//     threads keeps a ring of Q_STAGES K / V stages in flight (full and empty
//     mbarriers). hd <= 128: 128 query rows, 64 a warpgroup, each issuing
//     dP right behind S and computing P while dP runs. hd 256: 64 rows, S
//     on warpgroup 0 and dP on warpgroup 1 with the same hand-over, each
//     summing half the columns.
//   Products over the causal pairs: 7 at every head dim (Sᵀ, dPᵀ, dV, dK;
//   S, dP, dQ) against the 5 costs.flash_bwd counts: the price of no
//   float32 atomics on dQ, which would sum in another order on every run.
//   * Filling 132 SMs: at the train microbatches the (key tile, KV head,
//     row) grid is 64 (hd 256) or 128 (hd 128) blocks and the causal walk is
//     uneven (key tile 0 sees every query tile, the last one), so the
//     wrapper splits the G heads over up to MAX_SPLITS blocks
//     (flash_attention.bwd_splits); each writes float32 partial dK / dV, and
//     flash_bwd_sum adds them in split order. Key tile 0, the longest, is
//     launched first.
//   * Tiles entirely above the causal diagonal (shifted by q_start) or below
//     the window are never visited, by the block or by a warpgroup whose 64
//     rows they miss; the mask runs only on the tiles that straddle a
//     boundary. Query rows past S are zeros (P is 1 there, but dO, Q and
//     delta are 0, so they add nothing; dQ: lse = +inf, P = 0); key rows
//     past T are masked in dQ and never stored in dK / dV.
#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "tma_tiles.cuh"

namespace {

using namespace repro;

constexpr int BR = 64;        // rows of a warpgroup's tile: wgmma's M
constexpr int WIDE_HD = 128;  // up to this head dim each warpgroup owns 64 rows
constexpr int MAX_SPLITS = 4;  // parts of the G heads a dK / dV grid takes at most
constexpr int NWG = 2;        // consumer warpgroups of a dQ block (and of a dK / dV one at hd 256)
constexpr int DQ_NT = (NWG + 1) * 128;  // the dQ kernel's threads: and a producer warpgroup
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // its registers a thread
constexpr int BAR_DP = 1, BAR_FRAG = 2;  // the hand-over's named barriers (hd 256)
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct BwdGeo : TileGeo<HD> {
  using T = TileGeo<HD>;
  // up to WIDE_HD a warpgroup owns 64 rows and all columns of its block's
  // resident tiles; at hd 256 two share 64 rows and each sums half the columns
  static constexpr bool ROWS = HD <= WIDE_HD;
  static constexpr int TILE = T::TILE64;                     // bytes of a 64-row tile
  static constexpr int NCBW = ROWS ? T::NCB : T::NCB / NWG;  // column blocks a warpgroup sums
  static constexpr int XBUF = ROWS ? 0 : BR * BR * 4;        // the hand-over, hd 256
  // dK / dV: a block per 64 keys, one warpgroup (two blocks an SM) or two at hd 256
  static constexpr int KV_WGS = ROWS ? 1 : NWG;
  static constexpr int KV_NT = KV_WGS * 128;
  static constexpr int KV_STAGES = 2;
  static constexpr int KV_SMEM = 2 * TILE + KV_STAGES * 2 * TILE + XBUF;
  // dQ: a block per 128 query rows (64 a warpgroup), or 64 at hd 256
  static constexpr int Q_RES = ROWS ? NWG : 1;  // 64-row tiles of its Q and dO
  static constexpr int Q_ROWS = Q_RES * BR;
  static constexpr int Q_STAGES = ROWS ? 3 : 2;
  static constexpr int Q_SMEM = 2 * Q_RES * TILE + Q_STAGES * 2 * TILE + XBUF;
  static_assert(Q_SMEM + 1024 + 4096 <= 232448 && 2 * (KV_SMEM + 1024 + 4096) / KV_WGS <= 232448,
                "shared memory");
};

// this thread's warpgroup, as a value the compiler knows to be the same
// across the warp: the branches on it are the roles, which setmaxnreg gives
// their own register budgets only when no warp can diverge between them
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
}

// thread t's fragment of a warpgroup's 64 x 64 float32 accumulator, value i
// at word 128 i + t of the hand-over buffer
__device__ __forceinline__ void put_frag(float* x, const float (&v)[BR / 2], int t) {
#pragma unroll
  for (int i = 0; i < BR / 2; ++i) x[i * 128 + t] = v[i];
}
// a bf16 A operand of 64 rows x 64 k (BR / 16 k steps of 4 words), at word
// 128 (4 kk + w) + t, from `first` words on
__device__ __forceinline__ void put_a(uint32_t* x, const uint32_t (&a)[BR / 16][4], int first,
                                      int t) {
#pragma unroll
  for (int kk = 0; kk < BR / 16; ++kk)
#pragma unroll
    for (int w = 0; w < 4; ++w) x[(first + 4 * kk + w) * 128 + t] = a[kk][w];
}
__device__ __forceinline__ void get_a(const uint32_t* x, uint32_t (&a)[BR / 16][4], int first,
                                      int t) {
#pragma unroll
  for (int kk = 0; kk < BR / 16; ++kk)
#pragma unroll
    for (int w = 0; w < 4; ++w) a[kk][w] = x[(first + 4 * kk + w) * 128 + t];
}

// D = A·Bᵀ over the head dim, A and B 64-row K-major tiles (Sᵀ = K·Qᵀ and
// the like); D's old values are dead to the compiler
template <int HD>
__device__ __forceinline__ void product_kmajor(float (&d)[BR / 2], uint32_t a, uint32_t b) {
  wgmma_ss_n64_first(d, desc_kmajor<HD>(a, BR, 0), desc_kmajor<HD>(b, BR, 0));
#pragma unroll
  for (int kk = 1; kk < HD / 16; ++kk)
    wgmma_ss_n64(d, desc_kmajor<HD>(a, BR, kk), desc_kmajor<HD>(b, BR, kk), 1);
}

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(BwdGeo<HD>::KV_NT, 2 / BwdGeo<HD>::KV_WGS)
flash_bwd_dkdv(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               float* __restrict__ part, int B, int S, int Tk, int H, int K, int nsplit,
               int q_start, int window, float scale_log2, float scale) {
  using G = BwdGeo<HD>;
  constexpr int ST = G::KV_STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + ST];  // K / V, then the stages
  __shared__ int done[ST];  // warps done with a stage's current step
  __shared__ float sL[ST][BR], sDl[ST][BR];           // lse and delta of a stage
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle period
  const uint32_t sK = base, sV = base + G::TILE;
  auto sQ = [&](int st) { return base + (2 + 2 * st) * G::TILE; };
  auto sO = [&](int st) { return sQ(st) + G::TILE; };  // dO
  float* xf = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                       (2 + 2 * ST) * G::TILE);
  uint32_t* xu = reinterpret_cast<uint32_t*>(xf);
  const uint32_t bar_kv = smem_addr(&bars[0]);
  auto full = [&](int st) { return smem_addr(&bars[1 + st]); };

  const int x = blockIdx.x;  // (batch row, KV head, split) with the split fastest
  const int split = x % nsplit, kh = (x / nsplit) % K, b = x / (nsplit * K);
  const int k0 = blockIdx.y * BR;  // key tile 0, the longest walk, first
  const int Gq = H / K, gs = Gq / nsplit, h0 = kh * Gq + split * gs;
  // the query rows that some key of the block sees: [lo, hi)
  const int lo = max(0, k0 - q_start);
  const int hi = window > 0 ? min(S, k0 + BR - 1 + window - q_start) : S;
  const int qt0 = lo / BR, n_qt = hi > lo ? (hi + BR - 1) / BR - qt0 : 0;
  const int n_steps = gs * n_qt;
  const int tid = threadIdx.x, wg = warpgroup(), lane = tid & 31;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(full(st), 1);
      done[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // a warp loads step t's Q, dO, lse and delta into stage t % ST, all
  // asynchronously: stage t's full barrier completes with the last of them.
  // Rows past S are zeros (TMA's fill, and cp.async's): their P is 1 but
  // their dO, Q and delta are 0, so they add nothing to dV or dK.
  auto load_stage = [&](int t) {
    const int st = t % ST, h = h0 + t / n_qt, q0 = (qt0 + t % n_qt) * BR;
    for (int r = lane; r < BR; r += 32) {
      const int qi = q0 + r;
      const size_t at = ((size_t)b * H + h) * S + min(qi, S - 1);
      cp_async4(smem_addr(&sL[st][r]), lse + at, qi < S);
      cp_async4(smem_addr(&sDl[st][r]), delta + at, qi < S);
    }
    cp_async_mbar_arrive(full(st));
    __syncwarp();  // every lane's copies are tracked before lane 0's arrival
    if (lane == 0) {
      mbar_expect_tx(full(st), 2 * G::TILE);
#pragma unroll
      for (int cb = 0; cb < G::NCB; ++cb) {
        tma_load_4d(sQ(st) + cb * BR * G::ROWB, &tq, full(st), cb * G::BC, h, q0, b);
        tma_load_4d(sO(st) + cb * BR * G::ROWB, &tdo, full(st), cb * G::BC, h, q0, b);
      }
    }
    __syncwarp();
  };
  if (tid < 32 && n_steps > 0) {
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * G::TILE);
#pragma unroll
      for (int cb = 0; cb < G::NCB; ++cb) {
        tma_load_4d(sK + cb * BR * G::ROWB, &tk, bar_kv, cb * G::BC, kh, k0, b);
        tma_load_4d(sV + cb * BR * G::ROWB, &tv, bar_kv, cb * G::BC, kh, k0, b);
      }
    }
    for (int t = 0; t < ST && t < n_steps; ++t) load_stage(t);
  }

  const int wt = tid & 127, warp = wt >> 5;
  const int cb0 = G::ROWS ? 0 : wg * G::NCBW;  // this warpgroup's first column block
  // this thread's accumulator rows: keys r0 and r0 + 8 of the tile
  const int r0 = warp * 16 + (lane >> 2);
  const int kpos0 = k0 + r0, kpos1 = kpos0 + 8;
  float dva[G::NCBW][G::BC / 2], dka[G::NCBW][G::BC / 2];
#pragma unroll
  for (int cb = 0; cb < G::NCBW; ++cb)
#pragma unroll
    for (int i = 0; i < G::BC / 2; ++i) dva[cb][i] = dka[cb][i] = 0.f;
  float sacc[BR / 2], dpacc[BR / 2];  // written whole by their first product
  uint32_t pa[BR / 16][4], sa[BR / 16][4];

  // Pᵀ in place of Sᵀ (keys as rows, the stage's queries as columns)
  auto probs = [&](int st, int q0) {
    const bool need_mask = k0 + BR - 1 > q_start + q0 ||
                           (window > 0 && q_start + q0 + BR - 1 - k0 >= window);
#pragma unroll
    for (int j = 0; j < BR / 2; ++j) {
      const int c = 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);  // query column
      float pv = exp2f(sacc[j] * scale_log2 - sL[st][c] * LOG2E);
      if (need_mask) {
        const int kpos = (j & 2) ? kpos1 : kpos0, qpos = q_start + q0 + c;
        const bool ok = kpos <= qpos && (window <= 0 || qpos - kpos < window);
        pv = ok ? pv : 0.f;
      }
      sacc[j] = pv;
    }
  };
  // the bf16 A fragments: Pᵀ, and dSᵀ = Pᵀ∘(dPᵀ − delta), dPᵀ value i = dp(i)
  auto p_fragments = [&]() {
#pragma unroll
    for (int i = 0; i < BR / 2; i += 2) pa[i >> 3][(i >> 1) & 3] = pack_bf16(sacc[i], sacc[i + 1]);
  };
  auto ds_fragments = [&](int st, auto dp) {
#pragma unroll
    for (int i = 0; i < BR / 2; i += 2) {
      const int c = 8 * (i >> 2) + 2 * (lane & 3);
      sa[i >> 3][(i >> 1) & 3] = pack_bf16(sacc[i] * (dp(i) - sDl[st][c]),
                                           sacc[i + 1] * (dp(i + 1) - sDl[st][c + 1]));
    }
  };
  // dV += Pᵀ·dO and dK += dSᵀ·Q over this warpgroup's columns
  auto dv_products = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk)
#pragma unroll
      for (int cb = 0; cb < G::NCBW; ++cb)
        wgmma_rs<G::BC>(dva[cb], pa[kk], desc_mnmajor<HD>(sO(st), BR, cb0 + cb, kk));
  };
  auto dk_products = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk)
#pragma unroll
      for (int cb = 0; cb < G::NCBW; ++cb)
        wgmma_rs<G::BC>(dka[cb], sa[kk], desc_mnmajor<HD>(sQ(st), BR, cb0 + cb, kk));
  };

  if (n_steps > 0) mbar_wait(bar_kv, 0);
  __syncwarp();
  for (int t = 0; t < n_steps; ++t) {
    const int st = t % ST, q0 = (qt0 + t % n_qt) * BR;
    mbar_wait(full(st), (t / ST) & 1);
    __syncwarp();  // wgmma is .aligned: the warp reconverges after the wait

    if constexpr (G::ROWS) {
      // ---- Sᵀ = K·Qᵀ, then dPᵀ = V·dOᵀ as a second group ------------------
      wgmma_fence();
      product_kmajor<HD>(sacc, sK, sQ(st));
      wgmma_commit();
      product_kmajor<HD>(dpacc, sV, sO(st));
      wgmma_commit();
      wgmma_wait<1>();  // Sᵀ done, dPᵀ still running
      fence_regs(sacc);
      probs(st, q0);
      p_fragments();
      // ---- dV += Pᵀ·dO while dPᵀ finishes and dSᵀ is formed, then dK ------
      wgmma_fence();
      dv_products(st);
      wgmma_commit();
      wgmma_wait<1>();  // dPᵀ done, dV still running
      fence_regs(dpacc);
      ds_fragments(st, [&](int i) { return dpacc[i]; });
      wgmma_fence();
      dk_products(st);
      wgmma_commit();
    } else {
      // hd 256: warpgroup 0 computes Sᵀ = K·Qᵀ, warpgroup 1 dPᵀ = V·dOᵀ (in sacc)
      const uint32_t a = wg == 0 ? sK : sV, bt = wg == 0 ? sQ(st) : sO(st);
      wgmma_fence();
      product_kmajor<HD>(sacc, a, bt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      if (wg == 0) {
        probs(st, q0);
        named_sync(BAR_DP, G::KV_NT);  // dPᵀ is in the hand-over buffer
        p_fragments();
        ds_fragments(st, [&](int i) { return xf[i * 128 + wt]; });
        put_a(xu, pa, 0, wt);
        put_a(xu, sa, BR / 4, wt);
        named_arrive(BAR_FRAG, G::KV_NT);
      } else {
        put_frag(xf, sacc, wt);
        named_arrive(BAR_DP, G::KV_NT);
        named_sync(BAR_FRAG, G::KV_NT);  // Pᵀ and dSᵀ are in the buffer
        get_a(xu, pa, 0, wt);
        get_a(xu, sa, BR / 4, wt);
      }
      // ---- dV += Pᵀ·dO, dK += dSᵀ·Q over this warpgroup's columns ----------
      wgmma_fence();
      dv_products(st);
      dk_products(st);
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < G::NCBW; ++cb) {
      fence_regs(dva[cb]);
      fence_regs(dka[cb]);
    }
    // this warp is done with stage st: the last of the block's warps to be
    // done loads step t + ST into it
    int last = 0;
    if (lane == 0) {
      last = atomicAdd(&done[st], 1) == G::KV_WGS * 4 - 1;
      if (last) done[st] = 0;
    }
    if (__shfl_sync(0xffffffffu, last, 0) && t + ST < n_steps) load_stage(t + ST);
  }

  // ---- store: bf16 when one split, else this split's float32 partial -----
  const size_t n = (size_t)B * Tk * K * HD;
  auto store = [&](float (&acc)[G::NCBW][G::BC / 2], __nv_bfloat16* out, int which,
                   float mul) {
#pragma unroll
    for (int cb = 0; cb < G::NCBW; ++cb)
#pragma unroll
      for (int j = 0; j < G::BC / 8; ++j) {
        const int col = (cb0 + cb) * G::BC + 8 * j + 2 * (lane & 3);
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
  store(dka, dk, 0, scale);
  store(dva, dv, 1, 1.f);
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
__global__ void __launch_bounds__(DQ_NT, 1)
flash_bwd_dq(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int S, int Tk, int H, int K, int q_start,
             int window, float scale_log2, float scale) {
  using G = BwdGeo<HD>;
  constexpr int ST = G::Q_STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * ST];  // Q / dO; full, empty of each stage
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, sO = base + G::Q_RES * G::TILE;  // warpgroup w's rows at + w TILE
  auto sK = [&](int st) { return base + (2 * G::Q_RES + 2 * st) * G::TILE; };
  auto sV = [&](int st) { return sK(st) + G::TILE; };
  float* xf = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                       (2 * G::Q_RES + 2 * ST) * G::TILE);
  uint32_t* xu = reinterpret_cast<uint32_t*>(xf);
  const uint32_t bar_q = smem_addr(&bars[0]);
  auto full = [&](int st) { return smem_addr(&bars[1 + st]); };
  auto empty = [&](int st) { return smem_addr(&bars[1 + ST + st]); };

  const int h = blockIdx.x, qb = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = qb * G::Q_ROWS, nq = min(G::Q_ROWS, S - q0);
  const int k_end = min(Tk, q_start + q0 + nq);  // causal: keys <= the block's last query
  int k_beg = window > 0 ? max(0, q_start + q0 - window + 1) : 0;
  k_beg = (k_beg / BR) * BR;
  const int n_tiles = k_end > k_beg ? (k_end - k_beg + BR - 1) / BR : 0;
  const int tid = threadIdx.x, wg = warpgroup(), lane = tid & 31;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer: one thread; Q / dO once, then the K / V ring -------------
    setmaxnreg_dec<PRODUCER_REGS>();
    if ((tid & 127) == 0 && n_tiles > 0) {
      mbar_expect_tx(bar_q, 2 * G::Q_RES * G::TILE);
      for (int r = 0; r < G::Q_RES; ++r)
#pragma unroll
        for (int cb = 0; cb < G::NCB; ++cb) {
          const uint32_t at = r * G::TILE + cb * BR * G::ROWB;
          tma_load_4d(sQ + at, &tq, bar_q, cb * G::BC, h, q0 + r * BR, b);
          tma_load_4d(sO + at, &tdo, bar_q, cb * G::BC, h, q0 + r * BR, b);
        }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % ST, kt = k_beg + t * BR;
        if (t >= ST) mbar_wait(empty(st), (t / ST - 1) & 1);
        mbar_expect_tx(full(st), 2 * G::TILE);
#pragma unroll
        for (int cb = 0; cb < G::NCB; ++cb) {
          tma_load_4d(sK(st) + cb * BR * G::ROWB, &tk, full(st), cb * G::BC, kh, kt, b);
          tma_load_4d(sV(st) + cb * BR * G::ROWB, &tv, full(st), cb * G::BC, kh, kt, b);
        }
      }
    }
    return;
  }
  // ---- consumers ------------------------------------------------------------
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wt = tid & 127, warp = wt >> 5;
  const int qw0 = q0 + (G::ROWS ? wg * BR : 0);  // this warpgroup's first query row
  const uint32_t sQw = sQ + (G::ROWS ? wg * G::TILE : 0);
  const uint32_t sOw = sO + (G::ROWS ? wg * G::TILE : 0);
  const int cb0 = G::ROWS ? 0 : wg * G::NCBW;  // its first column block of dQ
  // this thread's rows: r0 and r0 + 8 of the tile
  const int r0 = warp * 16 + (lane >> 2);
  const int qpos0 = q_start + qw0 + r0, qpos1 = qpos0 + 8;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qw0 + r0 + 8 * r;
    const size_t at = ((size_t)b * H + h) * S + qi;
    lse2[r] = qi < S ? lse[at] * LOG2E : INFINITY;
    dl[r] = qi < S ? delta[at] : 0.f;
  }
  float dqa[G::NCBW][G::BC / 2];
#pragma unroll
  for (int cb = 0; cb < G::NCBW; ++cb)
#pragma unroll
    for (int i = 0; i < G::BC / 2; ++i) dqa[cb][i] = 0.f;
  float sacc[BR / 2], dpacc[BR / 2];  // written whole by their first product
  uint32_t sa[BR / 16][4];

  // P in place of S (queries as rows, the stage's keys as columns)
  auto probs = [&](int k0) {
    const bool need_mask = k0 + BR - 1 > q_start + qw0 || k0 + BR > Tk ||
                           (window > 0 && k0 < q_start + qw0 + BR - window);
#pragma unroll
    for (int j = 0; j < BR / 2; ++j) {
      const int r = (j >> 1) & 1;
      float p = exp2f(sacc[j] * scale_log2 - lse2[r]);
      if (need_mask) {
        const int kpos = k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        const int qpos = r ? qpos1 : qpos0;
        const bool ok = kpos < Tk && kpos <= qpos && (window <= 0 || qpos - kpos < window);
        p = ok ? p : 0.f;
      }
      sacc[j] = p;
    }
  };
  // dS = P∘(dP − delta) in bf16 A fragments, dP value i = dp(i)
  auto fragments = [&](auto dp) {
#pragma unroll
    for (int i = 0; i < BR / 2; i += 2) {
      const int r = (i >> 1) & 1;
      sa[i >> 3][(i >> 1) & 3] =
          pack_bf16(sacc[i] * (dp(i) - dl[r]), sacc[i + 1] * (dp(i + 1) - dl[r]));
    }
  };

  if (n_tiles > 0) mbar_wait(bar_q, 0);
  __syncwarp();
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % ST, k0 = k_beg + t * BR;
    mbar_wait(full(st), (t / ST) & 1);
    __syncwarp();

    bool live = true;
    if constexpr (G::ROWS) {  // does a query of this warpgroup see a key of the tile?
      live = qw0 < S && k0 <= q_start + qw0 + BR - 1 &&
             (window <= 0 || q_start + qw0 - (k0 + BR - 1) < window);
      if (live) {
        // ---- S = Q·Kᵀ, then dP = dO·Vᵀ as a second group --------------------
        wgmma_fence();
        product_kmajor<HD>(sacc, sQw, sK(st));
        wgmma_commit();
        product_kmajor<HD>(dpacc, sOw, sV(st));
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sacc);
        probs(k0);
        wgmma_wait<0>();
        fence_regs(dpacc);
        fragments([&](int i) { return dpacc[i]; });
      }
    } else {
      // hd 256: warpgroup 0 computes S = Q·Kᵀ, warpgroup 1 dP = dO·Vᵀ (in sacc)
      const uint32_t a = wg == 0 ? sQ : sO, bt = wg == 0 ? sK(st) : sV(st);
      wgmma_fence();
      product_kmajor<HD>(sacc, a, bt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      if (wg == 0) {
        probs(k0);
        named_sync(BAR_DP, NWG * 128);
        fragments([&](int i) { return xf[i * 128 + wt]; });
        put_a(xu, sa, 0, wt);
        named_arrive(BAR_FRAG, NWG * 128);
      } else {
        put_frag(xf, sacc, wt);
        named_arrive(BAR_DP, NWG * 128);
        named_sync(BAR_FRAG, NWG * 128);
        get_a(xu, sa, 0, wt);
      }
    }

    if (live) {
      // ---- dQ += dS·K over this warpgroup's columns ---------------------------
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BR / 16; ++kk)
#pragma unroll
        for (int cb = 0; cb < G::NCBW; ++cb)
          wgmma_rs<G::BC>(dqa[cb], sa[kk], desc_mnmajor<HD>(sK(st), BR, cb0 + cb, kk));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int cb = 0; cb < G::NCBW; ++cb) fence_regs(dqa[cb]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));  // this warp is done with stage st
  }

  const size_t row_stride = (size_t)H * HD;
  __nv_bfloat16* d0 = dq + ((size_t)(b * S + qw0 + r0) * H + h) * HD;
  __nv_bfloat16* d1 = d0 + 8 * row_stride;
#pragma unroll
  for (int cb = 0; cb < G::NCBW; ++cb)
#pragma unroll
    for (int j = 0; j < G::BC / 8; ++j) {
      const int col = (cb0 + cb) * G::BC + 8 * j + 2 * (lane & 3);
      if (qw0 + r0 < S)
        *reinterpret_cast<uint32_t*>(d0 + col) =
            pack_bf16(dqa[cb][4 * j] * scale, dqa[cb][4 * j + 1] * scale);
      if (qw0 + r0 + 8 < S)
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

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dq, void* dk, void* dv, float* part, int B, int S,
           int Tk, int H, int K, int q_start, int window, int nsplit, cudaStream_t st) {
  using G = BwdGeo<HD>;
  if (nsplit < 1 || nsplit > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  if (!tile_map<HD>(&tq, q, B, S, H) || !tile_map<HD>(&tk, k, B, Tk, K) ||
      !tile_map<HD>(&tv, v, B, Tk, K) || !tile_map<HD>(&tdo, dout, B, S, H))
    return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)HD), scale_log2 = LOG2E * scale;
  const int kv_smem = G::KV_SMEM + 1024;  // + room to align to the swizzle period
  auto kdkdv = flash_bwd_dkdv<HD>;
  cudaError_t e = allow_smem(kdkdv, kv_smem);
  if (e != cudaSuccess) return (int)e;
  kdkdv<<<dim3(B * K * nsplit, (Tk + BR - 1) / BR), G::KV_NT, kv_smem, st>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), part, B, S, Tk, H, K, nsplit, q_start, window,
      scale_log2, scale);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (nsplit > 1) {
    const size_t n = (size_t)B * Tk * K * HD;
    const int blocks = (int)std::min<size_t>((2 * n + 255) / 256, 132 * 16);
    flash_bwd_sum<<<blocks, 256, 0, st>>>(part, static_cast<__nv_bfloat16*>(dk),
                                          static_cast<__nv_bfloat16*>(dv), n, nsplit);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int q_smem = G::Q_SMEM + 1024;
  auto kdq = flash_bwd_dq<HD>;
  e = allow_smem(kdq, q_smem);
  if (e != cudaSuccess) return (int)e;
  kdq<<<dim3(H, (S + G::Q_ROWS - 1) / G::Q_ROWS, B), DQ_NT, q_smem, st>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dq), S, Tk, H, K, q_start,
      window, scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace

namespace repro {

// the bf16 route of flash_attention_bwd (flash_attention_bwd.cu), after its
// delta kernel: q, dout, dq [B, S, H, hd]; k, v, dk, dv [B, T, K, hd]; lse,
// delta float32 [B, H, S]; part: float32 [2, nsplit, B, T, K, hd] when
// nsplit > 1 (the G = H / K query heads of a KV head in nsplit splits, G a
// multiple of nsplit, nsplit <= MAX_SPLITS)
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
