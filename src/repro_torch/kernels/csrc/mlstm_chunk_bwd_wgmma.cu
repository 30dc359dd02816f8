// Chunkwise mLSTM backward for Hopper (sm_90a) in bf16: the pair products on
// the tensor cores (bf16 wgmma), the state products in TF32 (wgmma).
//
// Replaces the gradient of the Pallas TPU kernel src/repro/kernels/
// mlstm_chunk.py::mlstm_chunk for bf16 inputs. The reference has no backward
// kernel: it trains on XLA's autodiff of src/repro/models/xlstm.py::
// mlstm_chunkwise. Same contract and math as the plain version
// (kernels/mlstm_chunk.py::mlstm_chunk_bwd): the gradient of the chunkwise
// mLSTM at (q, k, v, ig, fg) given dh and an optional (dC, dn) of the state
// out, the state in held constant, every stabiliser held constant (exact),
// and the rounding carry of its docstring (a row's residual to its largest
// weight, a chunk's through m_next's reverse carry) in the gate phase. The
// float32 route, the gate phase both routes share and the C entry
// mlstm_chunk_bwd are in mlstm_chunk_bwd.cu.
//
// Per chunk of L rows (q pre-scaled by hd^-0.5 below, d_lm = exp(F_l - F_m +
// ig_m - m_l) for m <= l, w = (q·kᵀ) ⊙ d, C_c, n_c the chunk's start state,
// which the forward saved: with_states), with P = dh·vᵀ and X = dh·C_cᵀ:
//   per row   qn = inter (q·n_c) + Σ_m w, denom = max(|qn|, e^-m_l),
//             dh·h_num = inter q·X + Σ_m w ⊙ P, hence dqn, R, dinter;
//   per pair  ds' = d ⊙ (P / denom + dqn), dlogD = w ⊙ (P / denom + dqn);
//   dq = ds'·k + (inter / denom) X + dqn inter n_c,  dk = ds'ᵀ·q,
//   dv = (w / denom)ᵀ·dh, and from the state update of every chunk
//   dk += sc (dCE_c·v + dnE_c), dv += (k ⊙ sc)·dCE_c, where dCE_c, the
//   gradient of chunk c's end state, runs from the end:
//   dC <- dC decay_c + qᵀ·(dh ⊙ inter / denom), dn <- dn decay_c + Σ dqn inter q.
// (dh·(q C_c) is taken as q·X: X serves both the row scalars and dq, so the
// state takes four products, not five.)
//
// What bounds it on an H100: operations. At xlstm-350m's train microbatch
// ([4, 1024, 4, 512], L = 256) five products over the causal pairs (q·kᵀ and
// dh·vᵀ recomputed, ds'·k, ds'ᵀ·q, wᵀ·dh) are ~11 GFLOP in bf16 and four over
// the state (dh·Cᵀ, qᵀ·dh, v·dCEᵀ, (k ⊙ sc)·dCE) ~34 GFLOP in TF32, against
// ~184 MB of inputs, saved states and gradients: ~0.08 ms.
//
// Design: a simple, deterministic first kernel, seven launches (then the gate
// phase). Every block is one warpgroup (phase 0: two); every sum has one
// order (no atomics), so two calls on the same inputs give the same bits.
//   0. the state products (mlstm_bwd_slab), a block per (64 columns, chunk,
//      B·H): it loads its 64-row slab of the chunk's [hd][hd] matrix into
//      shared memory once; its two warpgroups walk the chunk's 64-row tiles
//      (even, odd) and write a·slabᵀ (TF32, a streamed 32 columns a step)
//      to a float32 [B·H, Sp, hd] scratch. Three uses: X = dh·C_cᵀ with each row's Σ q·X and q·n_c
//      over its columns (before phase 1); dCv = v·dCE_cᵀ with each key's
//      sc k·(dCv + dnE_c), and (k ⊙ sc)·dCE_c (both before phase 4).
//   1. rows, a block per (64-row query tile, chunk, B·H): the column sums of
//      phase 0; per key tile up to the diagonal S = q·kᵀ and P = dh·vᵀ
//      (bf16), the row sums Σ w and Σ w ⊙ P; the row scalars (denom, dqn, R,
//      dinter·inter) into a float32 scratch.
//   2. carry, a block per 64 x 64 tile of dC and B·H: the forward's chunk
//      state phase run backwards. It writes dCE_c (rounded to TF32: phase
//      0's operand) and dnE_c at every chunk, its share of Σ dCE_c ⊙ C_c +
//      dnE_c ⊙ n_c (the decay's gradient) and of the state out's m gradient,
//      then adds qᵀ·(dh inter / denom) as TF32 wgmma over transposed slabs.
//   3. dq, a block per (64 dq columns, query tile, chunk, B·H): (inter /
//      denom) X from phase 0's scratch, then per key tile S and P again, ds'
//      in registers as the bf16 A operand of ds'·k. The column-0 blocks
//      write each row's Σ dlogD.
//   4. dk / dv, a block per (64 columns, key tile, chunk, B·H), key tile 0
//      (the longest walk) first: per query tile from the diagonal on, Sᵀ =
//      k·qᵀ and Pᵀ = v·dhᵀ with the keys as wgmma's rows, ds'ᵀ and wᵀ / denom
//      in registers as A operands of ds'ᵀ·q and (wᵀ / denom)·dh; then the
//      state terms from phase 0's scratch. Column-0 blocks write each key's
//      Σ dlogD.
// The [L, L] tile of a (chunk, head) lives only in registers. Each chunk's
// saved C_c is read twice in all, never once a tile: by phase 0 (X) and,
// elementwise, by the carry (the decay's gradient); dCE_c is written once
// and read by phase 0's two later uses. Rows past S are zero in q, k, v, dh
// (zero fill) and give zeros.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;

constexpr int NT = 128;        // one warpgroup
constexpr int MAX_L = 512;     // the largest chunk
constexpr int TILE = 64;       // rows / keys / columns of a tile
constexpr int KI = 32;         // carry: chunk rows per TF32 slab (128 bytes)
constexpr int SLAB = TILE * 128;          // 64 rows of 128 bytes, swizzled
constexpr int STAGE = 4 * SLAB;           // a pair-ring stage: q, k, dh, v
constexpr int RING = 2 * STAGE;           // two stages
constexpr int RAW = TILE * 64;            // 64 rows x 32 bf16
constexpr int P2_PAIR = 2 * TILE * 128;   // carry: a TF32 slab pair
constexpr int P2_RAW = 2 * KI * 128;      // carry: raw bf16 rows of a step
constexpr int RAW_STAGES = 4;

// the float32 row scratch [B·H, NR, Sp] (shared with mlstm_chunk_bwd.cu)
enum { kDenom = 0, kDqn = 1, kR = 2, kDi = 3, kRowsum = 4, kColsum = 5, NR = 6 };

using bf16 = __nv_bfloat16;

// this thread's accumulator element i of a m64n64 tile: row, column
__device__ __forceinline__ int acc_row(int i, int r_lo) { return r_lo + 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int acc_col(int i, int tq) { return 8 * (i >> 2) + 2 * tq + (i & 1); }

// a [64][32] float32 slab, 128-byte rows in the swizzle: element (r, c)
__device__ __forceinline__ uint32_t f32_at(int r, int c) {
  return swz128(r, c >> 2) + (c & 3) * 4;
}

// raw [64 rows][32 bf16] (64-byte rows) widened into a swizzled [64][32]
// float32 slab, each row scaled by mul[r] (null: 1) and rounded to TF32
__device__ __forceinline__ void widen_rows(const uint8_t* raw, uint8_t* dst, int tid,
                                           const float* mul) {
  const int r = tid >> 1, half = tid & 1;
  const float f = mul != nullptr ? mul[r] : 1.f;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const uint4 w = *reinterpret_cast<const uint4*>(raw + r * 64 + half * 32 + 16 * x);
    const bf16* h = reinterpret_cast<const bf16*>(&w);
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = to_tf32(__bfloat162float(h[e]) * f);
    const int cq = half * 4 + x * 2;
    *reinterpret_cast<float4*>(dst + swz128(r, cq)) = make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(dst + swz128(r, cq + 1)) = make_float4(o[4], o[5], o[6], o[7]);
  }
}

// cp.async of 64 rows x 32 bf16 (columns col0..) of a [B, S, H, hd] tensor
// into raw[64][64 bytes]; rows p0 + row0 + r, zero past the chunk and S
__device__ __forceinline__ void load_raw(uint32_t raw, const bf16* head, size_t rs, int p0,
                                         int row0, int L, int S, int col0, int tid) {
  for (int e = tid; e < TILE * 4; e += NT) {
    const int r = e >> 2, ch = e & 3, j = row0 + r, p = p0 + j;
    const bool ok = j < L && p < S;
    cp_async16(raw + r * 64 + ch * 16, head + (size_t)(ok ? p : 0) * rs + col0 + ch * 8, ok);
  }
}

// cp.async of 64 rows x 32 float32 (rows row0.., columns col0..) of a
// row-major [hd][hd] matrix into a swizzled [64][32] float32 slab
__device__ __forceinline__ void load_rows_f32(uint32_t dst, const float* m, int hd, int row0,
                                              int col0, int tid) {
  for (int e = tid; e < TILE * 8; e += NT) {
    const int r = e >> 3, ch = e & 7;
    cp_async16(dst + swz128(r, ch), m + (size_t)(row0 + r) * hd + col0 + ch * 4, true);
  }
}

// The pair walk both query-side phases share: the slabs of q, k, dh and v
// for (key tile, 64-column slab) steps through a two-stage cp.async ring.
struct PairRing {
  uint32_t ring;
  const bf16 *q, *k, *dh, *v;
  size_t rs;
  int p0, S, NS;
  __device__ __forceinline__ uint32_t stage(int t) const { return ring + (t & 1) * STAGE; }
  // step t: query rows qrow0.., key rows krow0.., columns s * 64..
  __device__ __forceinline__ void issue(int qrow0, int krow0, int s, int t, int tid) const {
    const uint32_t sq = stage(t), sk = sq + SLAB, sd = sk + SLAB, sv = sd + SLAB;
    for (int e = tid; e < TILE * 8; e += NT) {
      const int r = e >> 3, ch = e & 7;
      const int pq = p0 + qrow0 + r, pk = p0 + krow0 + r;
      const size_t aq = (size_t)min(pq, S - 1) * rs + s * TILE + ch * 8;
      const size_t ak = (size_t)min(pk, S - 1) * rs + s * TILE + ch * 8;
      cp_async16(sq + swz128(r, ch), q + aq, pq < S);
      cp_async16(sk + swz128(r, ch), k + ak, pk < S);
      cp_async16(sd + swz128(r, ch), dh + aq, pq < S);
      cp_async16(sv + swz128(r, ch), v + ak, pk < S);
    }
  }
};

// a [64 rows][64 columns] bf16 tile (rows row0.., columns col0..) into a
// swizzled tile, zero past S
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* head, size_t rs, int p0,
                                          int row0, int S, int col0, int tid) {
  for (int e = tid; e < TILE * 8; e += NT) {
    const int r = e >> 3, ch = e & 7, p = p0 + row0 + r;
    cp_async16(dst + swz128(r, ch), head + (size_t)min(p, S - 1) * rs + col0 + ch * 8, p < S);
  }
}

// ---- phase 0: the state products, a chunk's matrix slab held in shared memory ----
enum { kSlabX = 0, kSlabDCv = 1, kSlabDvs = 2 };

constexpr int SLAB_NT = 2 * NT;                    // two warpgroups share a slab
constexpr int SLAB_WG = 2 * SLAB + RAW_STAGES * RAW;  // a warpgroup's ring

// warpgroup wg's barrier (0 is __syncthreads')
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "r"(NT) : "memory");
}

// Warpgroup wg's share (every other 32-row slab) of the block's slab of
// M(n0 + x, kk), x < 64, all kk, as hd / 32 swizzled [64][32] TF32 slabs:
// rows n0.. of M (cp.async) or, TRANS, its columns n0.., transposed through
// registers four 32-row slabs a round trip. A warp reads 8 rows x 16
// columns, so a store's lanes span 8 source rows: two to a bank at most.
template <bool TRANS>
__device__ __forceinline__ void load_slab(uint32_t dst, uint8_t* gdst, const float* m, int hd,
                                          int n0, int wg, int tid) {
  const int ND = hd / 32;
  if (!TRANS) {
    for (int ks = wg; ks < ND; ks += 2) load_rows_f32(dst + ks * SLAB, m, hd, n0, ks * 32, tid);
    return;
  }
  for (int k0 = wg; k0 < ND; k0 += 8) {
    float4 x[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int e = tid + it * NT, ks = k0 + 2 * u;
        const int r = (e & 7) + 8 * ((e >> 5) & 3), c4 = 4 * (((e >> 3) & 3) + 4 * (e >> 7));
        if (ks < ND)
          x[u][it] = *reinterpret_cast<const float4*>(m + (size_t)(ks * 32 + r) * hd + n0 + c4);
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int e = tid + it * NT, ks = k0 + 2 * u;
        const int r = (e & 7) + 8 * ((e >> 5) & 3), c4 = 4 * (((e >> 3) & 3) + 4 * (e >> 7));
        if (ks >= ND) continue;
        uint8_t* d = gdst + ks * SLAB;
        *reinterpret_cast<float*>(d + f32_at(c4 + 0, r)) = x[u][it].x;
        *reinterpret_cast<float*>(d + f32_at(c4 + 1, r)) = x[u][it].y;
        *reinterpret_cast<float*>(d + f32_at(c4 + 2, r)) = x[u][it].z;
        *reinterpret_cast<float*>(d + f32_at(c4 + 3, r)) = x[u][it].w;
      }
  }
}

// grid (hd / 64 column blocks, chunk, B·H), two warpgroups: out[bh, p0 + j,
// n0 + x] = Σ_kk a[j, kk] M(n0 + x, kk) for every row j of chunk c, in TF32.
// The block loads its [64 n][hd kk] slab of the chunk's M once; its two
// warpgroups walk the chunk's 64-row tiles (even, odd), each streaming a
// 32 columns a step. M(n, kk) is M_c[n][kk] (kSlabDCv) or M_c[kk][n].
//   kSlabX:   a = dh, M = CT (C_cᵀ), so X = dh·C_cᵀ; part [B·H, 2, ncol, Sp]
//             gets each row's Σ q·X and Σ q·n_c (vec = nS) over the block's
//             columns (b2 = q). A chunk with no start state gives zeros.
//   kSlabDCv: a = v, M = dCE, so dCv = v·dCE_cᵀ; part [B·H, ncol, Sp] gets
//             each key's sc Σ k·(dCv + dnE_c) (b2 = k, vec = dnE).
//   kSlabDvs: a = k ⊙ sc, M = dCE, so (k ⊙ sc)·dCE_c; no part.
// sc_m = exp(F_L - F_m + ig_m - m_next), the key's weight in the state update.
template <int MODE>
__global__ void __launch_bounds__(SLAB_NT)
mlstm_bwd_slab(const bf16* __restrict__ a, const bf16* __restrict__ b2,
         const float* __restrict__ M, const float* __restrict__ vec,
         const float* __restrict__ gates, const float* __restrict__ mS,
         float* __restrict__ out, float* __restrict__ part, int S, int H, int hd, int L,
         int nc, int Sp, int ntile, int has_state) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_addr(smem_raw));
  const int ND = hd / 32;
  const int wg = threadIdx.x / NT, tid = threadIdx.x % NT;
  // the warpgroup's 2 x [64][32] of a widened, RAW_STAGES x [64][32] of a raw bf16
  const uint32_t stg = base + ND * SLAB + wg * SLAB_WG;
  float* sMul = reinterpret_cast<float*>(gbase + ND * SLAB + 2 * SLAB_WG);  // [ntile * 64]
  float* sVec = sMul + ntile * TILE;                                       // [64]

  const int ct = blockIdx.x, c = blockIdx.y, bh = blockIdx.z, ncol = gridDim.x;
  const int b = bh / H, hh = bh - b * H;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int p0 = c * L, n0 = ct * TILE, r_lo = warp * 16 + g;
  const size_t rs = (size_t)H * hd;
  const size_t head = (size_t)b * S * rs + (size_t)hh * hd;
  const float* mat = M + ((size_t)bh * nc + c) * hd * hd;
  float* o = out + ((size_t)bh * Sp + p0) * hd + n0;
  auto part_at = [&](int x, int j) {
    return MODE == kSlabX ? part + (((size_t)bh * 2 + x) * ncol + ct) * Sp + p0 + j
                          : part + ((size_t)bh * ncol + ct) * Sp + p0 + j;
  };
  if (MODE == kSlabX && !(has_state || c > 0)) {  // C_c = 0, n_c = 0
    for (int e = threadIdx.x; e < L * TILE; e += SLAB_NT) o[(size_t)(e / TILE) * hd + e % TILE] = 0.f;
    for (int j = threadIdx.x; j < L; j += SLAB_NT) *part_at(0, j) = *part_at(1, j) = 0.f;
    return;
  }

  // a streamed through the warpgroup's RAW_STAGES ring, 32 columns a step,
  // widened one step ahead while the step's wgmma runs; its tiles wg, wg + 2, ..
  const int T = ((ntile - wg + 1) / 2) * ND;
  auto raw_at = [&](int t) { return stg + 2 * SLAB + (t % RAW_STAGES) * RAW; };
  auto wide_at = [&](int t) { return stg + (t & 1) * SLAB; };
  auto tile_of = [&](int t) { return wg + 2 * (t / ND); };
  auto issue = [&](int t) {
    if (t < T) load_raw(raw_at(t), a + head, rs, p0, tile_of(t) * TILE, L, S, (t % ND) * 32, tid);
    cp_async_commit();
  };
  auto widen = [&](int t) {
    widen_rows(gbase + (raw_at(t) - base), gbase + (wide_at(t) - base), tid,
               MODE == kSlabDvs ? sMul + tile_of(t) * TILE : nullptr);
  };
  for (int t = 0; t < RAW_STAGES - 1; ++t) issue(t);
  load_slab<MODE != kSlabDCv>(base, gbase, mat, hd, n0, wg, tid);  // the slab, once
  cp_async_commit();
  if (MODE != kSlabX) {
    const float* gF = gates + (size_t)bh * 3 * Sp + p0;
    const float m_c = mS[(size_t)bh * nc + c];
    const float FL = gF[L - 1];
    const float m_next = fmaxf(FL + m_c, gF[Sp + L - 1]);
    for (int m = threadIdx.x; m < ntile * TILE; m += SLAB_NT)
      sMul[m] = m < L ? expf(((FL - gF[m]) + gF[2 * Sp + m]) - m_next) : 0.f;
  }
  if (threadIdx.x < TILE)
    sVec[threadIdx.x] = MODE != kSlabDvs ? vec[((size_t)bh * nc + c) * hd + n0 + threadIdx.x] : 0.f;
  cp_async_wait<0>();
  __syncthreads();
  if (T > 0) widen(0);
  fence_async_smem();
  __syncthreads();
  float acc[32];
  for (int t = 0; t < T; ++t) {
    const int jt = tile_of(t), ks = t % ND;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_tf32_n64(acc, desc_k(wide_at(t), kk), desc_k(base + ks * SLAB, kk), ks > 0 || kk > 0);
    wgmma_commit();
    issue(t + RAW_STAGES - 1);  // into the stage step t - 1 widened
    if (t + 1 < T) {
      cp_async_wait<RAW_STAGES - 2>();
      wg_sync(wg);
      widen(t + 1);  // into the buffer step t - 1's wgmma read
    }
    wgmma_wait_all();
    fence_regs(acc);
    fence_async_smem();
    wg_sync(wg);
    if (ks != ND - 1) continue;
    // ---- tile jt is done: write it, and the partials over the block's columns ----------
    float pa[2] = {0.f, 0.f}, pb[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int hi = (i >> 1) & 1, j = jt * TILE + acc_row(i, r_lo), p = p0 + j;
      const int col = acc_col(i, tq);
      if (j >= L) continue;
      *reinterpret_cast<float2*>(o + (size_t)j * hd + col) = make_float2(acc[i], acc[i + 1]);
      if (MODE == kSlabDvs || p >= S) continue;
      const float2 x2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          b2 + head + (size_t)p * rs + n0 + col));
      if (MODE == kSlabX) {
        pa[hi] = fmaf(x2.x, acc[i], fmaf(x2.y, acc[i + 1], pa[hi]));
        pb[hi] = fmaf(x2.x, sVec[col], fmaf(x2.y, sVec[col + 1], pb[hi]));
      } else {
        pa[hi] = fmaf(x2.x, acc[i] + sVec[col], fmaf(x2.y, acc[i + 1] + sVec[col + 1], pa[hi]));
      }
    }
    if (MODE == kSlabDvs) continue;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
#pragma unroll
      for (int sh = 1; sh < 4; sh <<= 1) {
        pa[x] += __shfl_xor_sync(0xffffffffu, pa[x], sh);
        pb[x] += __shfl_xor_sync(0xffffffffu, pb[x], sh);
      }
    }
    if (tq == 0) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int j = jt * TILE + r_lo + 8 * x;
        if (j >= L) continue;
        if (MODE == kSlabX) {
          *part_at(0, j) = pa[x];
          *part_at(1, j) = pb[x];
        } else {
          *part_at(0, j) = sMul[j] * pa[x];
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ---- phase 1: rows -------------------------------------------------------------
__global__ void __launch_bounds__(NT)
mlstm_bwd_rows(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
         const bf16* __restrict__ dh, const float* __restrict__ gates,
         const float* __restrict__ xq, const float* __restrict__ mS,
         float* __restrict__ rows, int S, int H, int hd, int L, int nc, int Sp, int ntile,
         float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_addr(smem_raw));
  float* sF = reinterpret_cast<float*>(gbase + RING);  // [ntile * 64]
  float* sIg = sF + ntile * TILE;
  float* sMj = sIg + ntile * TILE;  // [64] per query row
  float* sInter = sMj + TILE;
  float* sEmj = sInter + TILE;
  float* sQn = sEmj + TILE;         // q·n_c
  float* sHx = sQn + TILE;          // q·X = dh·(q C_c)

  int idx = blockIdx.x;
  const int BH = gridDim.x / (nc * ntile);
  const int bh = idx % BH;
  idx /= BH;
  const int c = idx % nc, jt = ntile - 1 - idx / nc;
  const int b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int p0 = c * L, row0 = jt * TILE;
  const size_t rs = (size_t)H * hd;
  const size_t head = (size_t)b * S * rs + (size_t)hh * hd;
  const float* gF = gates + (size_t)bh * 3 * Sp + p0;
  const float m_c = mS[(size_t)bh * nc + c];
  const int nkeys = (jt + 1) * TILE;
  for (int i = tid; i < nkeys; i += NT) {
    sF[i] = i < L ? gF[i] : 0.f;
    sIg[i] = i < L ? gF[2 * Sp + i] : kNegInf;
  }
  if (tid < TILE) {
    const int j = row0 + tid;
    if (j < L) {
      const float m_inter = gF[j] + m_c;
      const float mj = fmaxf(m_inter, gF[Sp + j]);
      sMj[tid] = mj;
      sInter[tid] = expf(m_inter - mj);
      sEmj[tid] = expf(-mj);
    } else {
      sMj[tid] = 0.f;
      sInter[tid] = 0.f;
      sEmj[tid] = 1.f;
    }
    // phase 0's partials over the column blocks, summed in column order
    const int ncol = hd / TILE;
    float hx = 0.f, qn = 0.f;
    for (int ct = 0; ct < ncol && j < L; ++ct) {
      hx += xq[(((size_t)bh * 2 + 0) * ncol + ct) * Sp + p0 + j];
      qn += xq[(((size_t)bh * 2 + 1) * ncol + ct) * Sp + p0 + j];
    }
    sHx[tid] = hx * scale;
    sQn[tid] = qn * scale;
  }
  __syncthreads();

  const int r_lo = warp * 16 + g;
  float sacc[32], pacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.f;

  // ---- a. per key tile: S = q·kᵀ, P = dh·vᵀ; Σ w and Σ w ⊙ P ------------------------
  const int NS = hd / TILE, U = (jt + 1) * NS;
  const PairRing pr{base, q + head, k + head, dh + head, v + head, rs, p0, S, NS};
  auto issue = [&](int t) {
    if (t < U) pr.issue(row0, (t / NS) * TILE, t % NS, t, tid);
    cp_async_commit();
  };
  issue(0);
  float wsum[2] = {0.f, 0.f}, wp[2] = {0.f, 0.f};
  for (int t = 0; t < U; ++t) {
    const int it = t / NS, s = t - it * NS;
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    issue(t + 1);
    const uint32_t sq = pr.stage(t), sk = sq + SLAB, sd = sk + SLAB, sv = sd + SLAB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(sacc, desc_k(sq, kk), desc_k(sk, kk), s > 0 || kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(pacc, desc_k(sd, kk), desc_k(sv, kk), s > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);
    fence_regs(pacc);
    if (s != NS - 1) continue;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hi = (i >> 1) & 1, r = acc_row(i, r_lo), jl = row0 + r;
      const int il = it * TILE + acc_col(i, tq);
      if (il <= jl && jl < L) {
        const float w = sacc[i] * scale * expf(((sF[jl] - sF[il]) + sIg[il]) - sMj[r]);
        wsum[hi] += w;
        wp[hi] = fmaf(w, pacc[i], wp[hi]);
      }
    }
  }
  cp_async_wait<0>();

  // ---- b. the row scalars ----------------------------------------------------------------
#pragma unroll
  for (int x = 0; x < 2; ++x) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      wsum[x] += __shfl_xor_sync(0xffffffffu, wsum[x], o);
      wp[x] += __shfl_xor_sync(0xffffffffu, wp[x], o);
    }
  }
  if (tq == 0) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = r_lo + 8 * x, j = row0 + r;
      if (j >= L) continue;
      const float inter = sInter[r], lo = sEmj[r], qn_c = sQn[r], h_x = sHx[r];
      const float qn = inter * qn_c + wsum[x];
      const float aq = fabsf(qn);
      const float denom = fmaxf(aq, lo);
      const float dhh = inter * h_x + wp[x];
      const float ddenom = -dhh / (denom * denom);
      const float br = aq > lo ? 1.f : (aq == lo ? 0.5f : 0.f);
      const float sg = qn > 0.f ? 1.f : (qn < 0.f ? -1.f : 0.f);
      const float dqn = ddenom * br * sg;
      const float dinter = h_x / denom + dqn * qn_c;
      const float lb = aq < lo ? 1.f : (aq == lo ? 0.5f : 0.f);
      float* rw = rows + (size_t)bh * NR * Sp + p0 + j;
      rw[kDenom * Sp] = denom;
      rw[kDqn * Sp] = dqn;
      rw[kR * Sp] = lb * dhh / denom;
      rw[kDi * Sp] = dinter * inter;
    }
  }
}

// ---- phase 2: the reverse carry of (dC, dn) ------------------------------------------
// grid (hd / 64 columns e, hd / 64 rows d, B·H); the forward's mlstm_states
// walked from the last chunk: dCE_c = dC; dC = dC decay_c + GC_c
__global__ void __launch_bounds__(NT)
mlstm_bwd_carry(const bf16* __restrict__ q, const bf16* __restrict__ dh,
          const float* __restrict__ gates, const float* __restrict__ CT,
          const float* __restrict__ nS, const float* __restrict__ mS,
          const float* __restrict__ rows, const float* __restrict__ dCout,
          const float* __restrict__ dnout, const float* __restrict__ Cend,
          const float* __restrict__ nend, float* __restrict__ dCE, float* __restrict__ dnE,
          float* __restrict__ ddp, float* __restrict__ dmp, int S, int H, int hd, int L,
          int nc, int Sp, float scale, int has_state) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t raw = base + 2 * P2_PAIR;
  float* sCoef = reinterpret_cast<float*>(gbase + 2 * P2_PAIR + RAW_STAGES * P2_RAW);
  float* sW2 = sCoef + MAX_L;
  float* sN = sW2 + MAX_L;   // [64] dn of this d tile
  float* sRed = sN + TILE;   // [4] a block sum's warp parts

  const int et = blockIdx.x, dt = blockIdx.y, bh = blockIdx.z, b = bh / H, hh = bh - b * H;
  const int e0 = et * TILE, d0 = dt * TILE, ntd = gridDim.x;
  const int NP = gridDim.x * gridDim.y, part = dt * ntd + et;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const float* gF = gates + (size_t)bh * 3 * Sp;
  const float* gM = gF + Sp;
  const size_t rs = (size_t)H * hd;
  const bf16* qb = q + (size_t)b * S * rs + (size_t)hh * hd + d0;
  const bf16* db = dh + (size_t)b * S * rs + (size_t)hh * hd + e0;
  const float* rw = rows + (size_t)bh * NR * Sp;

  // a block's sum of one value per thread, in one order
  auto block_sum = [&](float x) {
    x = warp_sum(x);
    __syncthreads();
    if (lane == 0) sRed[warp] = x;
    __syncthreads();
    return ((sRed[0] + sRed[1]) + sRed[2]) + sRed[3];
  };

  const int ra = warp * 16 + g;
  float acc[32];
  float dm = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int d = d0 + ra + 8 * ((i >> 1) & 1), e = e0 + 8 * (i >> 2) + 2 * tq + (i & 1);
    const size_t at = ((size_t)bh * hd + d) * hd + e;
    acc[i] = dCout != nullptr ? dCout[at] : 0.f;
    if (dCout != nullptr) dm = fmaf(acc[i], Cend[at], dm);
  }
  if (tid < TILE) {
    sN[tid] = dnout != nullptr ? dnout[(size_t)bh * hd + d0 + tid] : 0.f;
    if (dnout != nullptr && et == 0) dm = fmaf(sN[tid], nend[(size_t)bh * hd + d0 + tid], dm);
  }
  dm = block_sum(dm);
  if (tid == 0) dmp[(size_t)bh * NP + part] = dm;

  const int nsteps = (L + KI - 1) / KI, T = nc * nsteps;
  auto issue = [&](int t) {  // step t of the reverse walk: chunk nc - 1 - t / nsteps
    if (t < T) {
      const int c = nc - 1 - t / nsteps, i0 = (t % nsteps) * KI;
      const uint32_t dq = raw + (t % RAW_STAGES) * P2_RAW, dd = dq + KI * 128;
      for (int e = tid; e < KI * 8; e += NT) {
        const int r = e >> 3, ch = e & 7, i = i0 + r, p = c * L + i;
        const bool ok = i < L && p < S;
        const size_t at = (size_t)(ok ? p : 0) * rs + ch * 8;
        cp_async16(dq + swz128(r, ch), qb + at, ok);
        cp_async16(dd + swz128(r, ch), db + at, ok);
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < RAW_STAGES - 1; ++t) issue(t);

  for (int cr = 0; cr < nc; ++cr) {
    const int c = nc - 1 - cr, p0 = c * L;
    __syncthreads();  // sN of the previous chunk is settled
    // ---- dCE_c, dnE_c and the decay's gradient ---------------------------------------
    float* dce = dCE + ((size_t)bh * nc + c) * hd * hd;
    const float* ct = CT + ((size_t)bh * nc + c) * hd * hd;
    const bool live = has_state || c > 0;
    float dd = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int d = d0 + ra + 8 * ((i >> 1) & 1), e = e0 + 8 * (i >> 2) + 2 * tq + (i & 1);
      dce[(size_t)d * hd + e] = to_tf32(acc[i]);
      if (live) dd = fmaf(acc[i], ct[(size_t)e * hd + d], dd);
    }
    if (et == 0 && tid < TILE) {
      dnE[((size_t)bh * nc + c) * hd + d0 + tid] = sN[tid];
      dd = fmaf(sN[tid], nS[((size_t)bh * nc + c) * hd + d0 + tid], dd);
    }
    dd = block_sum(dd);
    if (tid == 0) ddp[((size_t)bh * nc + c) * NP + part] = dd;
    // ---- the rows' weights: q·coef into dC, q·w2 into dn ---------------------------------
    const float m_c = mS[(size_t)bh * nc + c];
    const float FL = gF[p0 + L - 1];
    const float m_next = fmaxf(FL + m_c, gM[p0 + L - 1]);
    const float decay = expf((FL + m_c) - m_next);
    for (int i = tid; i < nsteps * KI; i += NT) {
      float cf = 0.f, w2 = 0.f;
      if (i < L) {
        const float m_inter = gF[p0 + i] + m_c;
        const float inter = expf(m_inter - fmaxf(m_inter, gM[p0 + i]));
        cf = scale * inter / rw[kDenom * Sp + p0 + i];
        w2 = scale * rw[kDqn * Sp + p0 + i] * inter;
      }
      sCoef[i] = cf;
      sW2[i] = w2;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= decay;
    float np[2][8];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 8; ++e) np[u][e] = 0.f;
    for (int s = 0; s < nsteps; ++s) {
      const int t = cr * nsteps + s;
      cp_async_wait<RAW_STAGES - 2>();
      __syncthreads();
      issue(t + RAW_STAGES - 1);
      const uint8_t* rq = gbase + (raw - base) + (t % RAW_STAGES) * P2_RAW;
      const uint8_t* rd = rq + KI * 128;
      uint8_t* A = gbase + (t & 1) * P2_PAIR;
      uint8_t* Bm = A + P2_PAIR / 2;
      const float cf = sCoef[s * KI + lane], w2 = sW2[s * KI + lane];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int cv = warp + 4 * u;
        const uint4 qr = *reinterpret_cast<const uint4*>(rq + swz128(lane, cv));
        const uint4 dr = *reinterpret_cast<const uint4*>(rd + swz128(lane, cv));
        const bf16* qh = reinterpret_cast<const bf16*>(&qr);
        const bf16* dhh = reinterpret_cast<const bf16*>(&dr);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int r = cv * 8 + e;
          const uint32_t off = swz128(r, lane >> 2) + (lane & 3) * 4;
          const float qv = __bfloat162float(qh[e]);
          np[u][e] = fmaf(qv, w2, np[u][e]);
          *reinterpret_cast<float*>(A + off) = to_tf32(qv * cf);
          *reinterpret_cast<float*>(Bm + off) = __bfloat162float(dhh[e]);
        }
      }
      fence_async_smem();
      __syncthreads();
      const uint32_t sA = base + (t & 1) * P2_PAIR, sB = sA + P2_PAIR / 2;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_tf32_n64(acc, desc_k(sA, kk), desc_k(sB, kk), 1);
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 8; ++e) np[u][e] = warp_sum(np[u][e]);
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int r = (warp + 4 * u) * 8 + e;
          sN[r] = sN[r] * decay + np[u][e];
        }
    }
  }
  cp_async_wait<0>();
}

// ---- phase 3: dq -------------------------------------------------------------------
// one block per (64 dq columns, B·H, chunk, query tile), longest tiles first
__global__ void __launch_bounds__(NT)
mlstm_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
       const bf16* __restrict__ dh, const float* __restrict__ gates,
       const float* __restrict__ X, const float* __restrict__ nS,
       const float* __restrict__ mS, float* __restrict__ rows, bf16* __restrict__ dq, int S,
       int H, int hd, int L, int nc, int Sp, int ntile, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t kbuf = base + RING;  // 2 x [64 keys][64 columns] of k
  float* sF = reinterpret_cast<float*>(gbase + RING + 2 * SLAB);  // [ntile * 64]
  float* sIg = sF + ntile * TILE;
  float* sMj = sIg + ntile * TILE;  // [64] per query row
  float* sCx = sMj + TILE;          // inter / denom
  float* sInter = sCx + TILE;
  float* sDen = sInter + TILE;
  float* sDqn = sDen + TILE;
  float* sNq = sDqn + TILE;         // [64] n_c of the columns

  const int ncol = hd / TILE;
  int idx = blockIdx.x;
  const int ct = idx % ncol;
  idx /= ncol;
  const int BH = gridDim.x / (ncol * nc * ntile);
  const int bh = idx % BH;
  idx /= BH;
  const int c = idx % nc, jt = ntile - 1 - idx / nc;
  const int b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int p0 = c * L, row0 = jt * TILE, d0 = ct * TILE;
  const size_t rs = (size_t)H * hd;
  const size_t head = (size_t)b * S * rs + (size_t)hh * hd;
  const float* gF = gates + (size_t)bh * 3 * Sp + p0;
  const float* rw = rows + (size_t)bh * NR * Sp + p0;
  const float m_c = mS[(size_t)bh * nc + c];
  const int nkeys = (jt + 1) * TILE;
  for (int i = tid; i < nkeys; i += NT) {
    sF[i] = i < L ? gF[i] : 0.f;
    sIg[i] = i < L ? gF[2 * Sp + i] : kNegInf;
  }
  if (tid < TILE) {
    const int j = row0 + tid;
    float mj = 0.f, inter = 0.f, den = 1.f, dqn = 0.f;
    if (j < L) {
      const float m_inter = gF[j] + m_c;
      mj = fmaxf(m_inter, gF[Sp + j]);
      inter = expf(m_inter - mj);
      den = rw[kDenom * Sp + j];
      dqn = rw[kDqn * Sp + j];
    }
    sMj[tid] = mj;
    sCx[tid] = inter / den;
    sInter[tid] = inter;
    sDen[tid] = den;
    sDqn[tid] = dqn;
    sNq[tid] = nS[((size_t)bh * nc + c) * hd + d0 + tid];
  }
  __syncthreads();

  // ---- a. (inter / denom) X over the dq columns, from phase 0 ---------------------------
  const int r_lo = warp * 16 + g;
  const float* xr = X + ((size_t)bh * Sp + p0) * hd + d0;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = acc_row(i, r_lo), j = row0 + r;
    acc[i] = j < L ? xr[(size_t)j * hd + acc_col(i, tq)] * sCx[r] : 0.f;
  }

  // ---- b. per key tile: S, P; ds' = d ⊙ (P / denom + dqn); dq += ds'·k ---------------
  const int NS = hd / TILE, U = (jt + 1) * NS;
  const PairRing pr{base, q + head, k + head, dh + head, v + head, rs, p0, S, NS};
  auto issue = [&](int t) {
    if (t < U) {
      const int it = t / NS, s = t % NS;
      pr.issue(row0, it * TILE, s, t, tid);
      if (s == 0) load_tile(kbuf + (it & 1) * SLAB, k + head, rs, p0, it * TILE, S, d0, tid);
    }
    cp_async_commit();
  };
  issue(0);
  float sacc[32], pacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.f;
  float rsum[2] = {0.f, 0.f};
  for (int t = 0; t < U; ++t) {
    const int it = t / NS, s = t - it * NS;
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    issue(t + 1);
    const uint32_t sq = pr.stage(t), sk = sq + SLAB, sd = sk + SLAB, sv = sd + SLAB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(sacc, desc_k(sq, kk), desc_k(sk, kk), s > 0 || kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(pacc, desc_k(sd, kk), desc_k(sv, kk), s > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);
    fence_regs(pacc);
    if (s != NS - 1) continue;
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int hi = (i >> 1) & 1, r = acc_row(i, r_lo), jl = row0 + r;
      float ds[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int il = it * TILE + acc_col(i + x, tq);
        ds[x] = 0.f;
        if (il <= jl && jl < L) {
          const float dd = expf(((sF[jl] - sF[il]) + sIg[il]) - sMj[r]);
          const float tt = pacc[i + x] / sDen[r] + sDqn[r];
          ds[x] = dd * tt;
          rsum[hi] = fmaf(sacc[i + x] * scale * dd, tt, rsum[hi]);
        }
      }
      pa[i >> 3][(i >> 1) & 3] = pack_bf16(ds[0], ds[1]);
    }
    const uint32_t kt = kbuf + (it & 1) * SLAB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(acc, pa[kk], desc_v(kt, 0, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  cp_async_wait<0>();

  // ---- epilogue: dq = scale (acc + dqn inter n_c) ------------------------------------------
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    rsum[x] += __shfl_xor_sync(0xffffffffu, rsum[x], 1);
    rsum[x] += __shfl_xor_sync(0xffffffffu, rsum[x], 2);
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = r_lo + 8 * x, j = row0 + r, p = p0 + j;
    if (j >= L) continue;
    if (ct == 0 && tq == 0) rows[((size_t)bh * NR + kRowsum) * Sp + p0 + j] = rsum[x];
    if (p >= S) continue;
    const float dqi = sDqn[r] * sInter[r];
    bf16* out = dq + head + (size_t)p * rs + d0;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = 8 * jj + 2 * tq;
      const int i = 4 * jj + 2 * x;
      *reinterpret_cast<uint32_t*>(out + col) = pack_bf16(
          scale * fmaf(dqi, sNq[col], acc[i]), scale * fmaf(dqi, sNq[col + 1], acc[i + 1]));
    }
  }
}

// ---- phase 4: dk, dv ----------------------------------------------------------------
// one block per (64 columns, B·H, chunk, key tile), key tile 0 first
__global__ void __launch_bounds__(NT)
mlstm_bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
         const bf16* __restrict__ dh, const float* __restrict__ gates,
         const float* __restrict__ mS, float* __restrict__ rows,
         const float* __restrict__ dCv, const float* __restrict__ dvs,
         const float* __restrict__ dnE, bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
         int H, int hd, int L, int nc, int Sp, int ntile, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t cbuf = base + RING;  // 2 x ([64 queries][64 columns] of q, then of dh)
  float* sF = reinterpret_cast<float*>(gbase + RING + 4 * SLAB);  // [ntile * 64]
  float* sIg = sF + ntile * TILE;
  float* sMj = sIg + ntile * TILE;  // every query row of the chunk
  float* sDen = sMj + ntile * TILE;
  float* sDqn = sDen + ntile * TILE;
  float* sSc = sDqn + ntile * TILE; // [64] the tile's keys' update weights
  float* sDn = sSc + TILE;          // [64] dnE_c of the columns

  const int ncol = hd / TILE;
  int idx = blockIdx.x;
  const int ct = idx % ncol;
  idx /= ncol;
  const int BH = gridDim.x / (ncol * nc * ntile);
  const int bh = idx % BH;
  idx /= BH;
  const int c = idx % nc, it = idx / nc;
  const int b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int p0 = c * L, key0 = it * TILE, c0 = ct * TILE;
  const size_t rs = (size_t)H * hd;
  const size_t head = (size_t)b * S * rs + (size_t)hh * hd;
  const float* gF = gates + (size_t)bh * 3 * Sp + p0;
  const float* rw = rows + (size_t)bh * NR * Sp + p0;
  const float m_c = mS[(size_t)bh * nc + c];
  const int nrows = ntile * TILE;
  for (int i = tid; i < nrows; i += NT) {
    float f = 0.f, ig = kNegInf, mj = 0.f, den = 1.f, dqn = 0.f;
    if (i < L) {
      f = gF[i];
      ig = gF[2 * Sp + i];
      mj = fmaxf(f + m_c, gF[Sp + i]);
      den = rw[kDenom * Sp + i];
      dqn = rw[kDqn * Sp + i];
    }
    sF[i] = f;
    sIg[i] = ig;
    sMj[i] = mj;
    sDen[i] = den;
    sDqn[i] = dqn;
  }
  const float FL = gF[L - 1];
  const float m_next = fmaxf(FL + m_c, gF[Sp + L - 1]);
  if (tid < TILE) {
    const int m = key0 + tid;
    sSc[tid] = m < L ? expf(((FL - gF[m]) + gF[2 * Sp + m]) - m_next) : 0.f;
    sDn[tid] = dnE[((size_t)bh * nc + c) * hd + c0 + tid];
  }
  __syncthreads();

  const int r_lo = warp * 16 + g;
  float dka[32], dva[32], sacc[32], pacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = sacc[i] = pacc[i] = 0.f;
  float csum[2] = {0.f, 0.f};

  // ---- a. per query tile from the diagonal: Sᵀ = k·qᵀ, Pᵀ = v·dhᵀ ----------------
  const int NS = hd / TILE, nq = ntile - it, U = nq * NS;
  const PairRing pr{base, q + head, k + head, dh + head, v + head, rs, p0, S, NS};
  auto issue = [&](int t) {
    if (t < U) {
      const int jq = t / NS, s = t % NS, qrow0 = (it + jq) * TILE;
      pr.issue(qrow0, key0, s, t, tid);
      if (s == 0) {
        const uint32_t cb = cbuf + (jq & 1) * 2 * SLAB;
        load_tile(cb, q + head, rs, p0, qrow0, S, c0, tid);
        load_tile(cb + SLAB, dh + head, rs, p0, qrow0, S, c0, tid);
      }
    }
    cp_async_commit();
  };
  issue(0);
  for (int t = 0; t < U; ++t) {
    const int jq = t / NS, s = t - jq * NS, qrow0 = (it + jq) * TILE;
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    issue(t + 1);
    const uint32_t sq = pr.stage(t), sk = sq + SLAB, sd = sk + SLAB, sv = sd + SLAB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(sacc, desc_k(sk, kk), desc_k(sq, kk), s > 0 || kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(pacc, desc_k(sv, kk), desc_k(sd, kk), s > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);
    fence_regs(pacc);
    if (s != NS - 1) continue;
    uint32_t pa[4][4], pb[4][4];  // ds'ᵀ and wᵀ / denom in bf16
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int hi = (i >> 1) & 1, m = key0 + acc_row(i, r_lo);
      float ds[2], wd[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int l = qrow0 + acc_col(i + x, tq);
        ds[x] = wd[x] = 0.f;
        if (m <= l && l < L) {
          const float dd = expf(((sF[l] - sF[m]) + sIg[m]) - sMj[l]);
          const float w = sacc[i + x] * scale * dd;
          const float tt = pacc[i + x] / sDen[l] + sDqn[l];
          ds[x] = dd * tt;
          wd[x] = w / sDen[l];
          csum[hi] = fmaf(w, tt, csum[hi]);
        }
      }
      pa[i >> 3][(i >> 1) & 3] = pack_bf16(ds[0], ds[1]);
      pb[i >> 3][(i >> 1) & 3] = pack_bf16(wd[0], wd[1]);
    }
    const uint32_t cb = cbuf + (jq & 1) * 2 * SLAB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_n64(dka, pa[kk], desc_v(cb, 0, kk));
      wgmma_rs_n64(dva, pb[kk], desc_v(cb + SLAB, 0, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dka);
    fence_regs(dva);
  }
  cp_async_wait<0>();

  // ---- epilogue: the state terms from phase 0; dk = scale dka + sc (dCv + dnE) -------
  const float* cvr = dCv + ((size_t)bh * Sp + p0) * hd + c0;
  const float* svr = dvs + ((size_t)bh * Sp + p0) * hd + c0;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = acc_row(i, r_lo), m = key0 + r, col = acc_col(i, tq);
    if (m >= L) continue;
    const float2 cv = *reinterpret_cast<const float2*>(cvr + (size_t)m * hd + col);
    const float2 sv = *reinterpret_cast<const float2*>(svr + (size_t)m * hd + col);
    const float sc = sSc[r];
    dka[i] = fmaf(sc, cv.x + sDn[col], scale * dka[i]);
    dka[i + 1] = fmaf(sc, cv.y + sDn[col + 1], scale * dka[i + 1]);
    dva[i] += sv.x;
    dva[i + 1] += sv.y;
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      csum[x] += __shfl_xor_sync(0xffffffffu, csum[x], o);
    }
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = r_lo + 8 * x, m = key0 + r, p = p0 + m;
    if (m >= L) continue;
    if (tq == 0 && ct == 0) rows[((size_t)bh * NR + kColsum) * Sp + p0 + m] = csum[x];
    if (p >= S) continue;
    bf16* ok = dk + head + (size_t)p * rs + c0;
    bf16* ov = dv + head + (size_t)p * rs + c0;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = 8 * jj + 2 * tq, i = 4 * jj + 2 * x;
      *reinterpret_cast<uint32_t*>(ok + col) = pack_bf16(dka[i], dka[i + 1]);
      *reinterpret_cast<uint32_t*>(ov + col) = pack_bf16(dva[i], dva[i + 1]);
    }
  }
}

template <typename K>
cudaError_t set_smem(K kern, int smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

namespace repro {

// Phases 0-4 of the bf16 backward (mlstm_chunk_bwd.cu runs the gate phase
// after them). q, k, v, dh, dq, dk, dv [B, S, H, hd] bf16; the forward's
// saved float32 gates [B·H, 3, Sp], CT [B·H, nc, hd, hd] (C_cᵀ in TF32), nS
// [B·H, nc, hd], mS [B·H, nc]; dCout / dnout (the state out's gradient) and
// Cend / nend (the state out) float32 or null; float32 scratch rows
// [B·H, 6, Sp], dlsc [B·H, hd / 64, Sp], dCE [B·H, nc, hd, hd], dnE [B·H, nc,
// hd], ddp [B·H, nc, (hd / 64)^2], dmp [B·H, (hd / 64)^2], xs [2, B·H, Sp,
// hd] (phase 0's products: X, then dCv; (k ⊙ sc)·dCE), xq [B·H, 2, hd / 64,
// Sp]. hd a multiple of 64 up to 512, 1 <= L <= 512.
int mlstm_chunk_bwd_wgmma(const void* q, const void* k, const void* v, const void* dh,
                          const float* gates, const float* CT, const float* nS,
                          const float* mS, const float* dCout, const float* dnout,
                          const float* Cend, const float* nend, void* dq, void* dk, void* dv,
                          float* rows, float* dlsc, float* dCE, float* dnE, float* ddp,
                          float* dmp, float* xs, float* xq, int B, int S, int H, int hd, int L,
                          float scale, int has_state, cudaStream_t st) {
  if (hd % TILE != 0 || hd > 512 || L < 1 || L > MAX_L) return (int)cudaErrorInvalidValue;
  const int BH = B * H, nc = (S + L - 1) / L, Sp = nc * L, ntile = (L + TILE - 1) / TILE;
  const int ncol = hd / TILE;
  auto Q = static_cast<const bf16*>(q);
  auto K_ = static_cast<const bf16*>(k);
  auto V = static_cast<const bf16*>(v);
  auto DH = static_cast<const bf16*>(dh);
  float* X = xs;                             // X, then dCv
  float* DVS = xs + (size_t)BH * Sp * hd;    // (k ⊙ sc)·dCE
  cudaError_t e;

  const int smem0 = 1024 + (hd / 32) * SLAB + 2 * SLAB_WG +
                    (int)sizeof(float) * (ntile * TILE + TILE);
  if ((e = set_smem(mlstm_bwd_slab<kSlabX>, smem0)) != cudaSuccess ||
      (e = set_smem(mlstm_bwd_slab<kSlabDCv>, smem0)) != cudaSuccess ||
      (e = set_smem(mlstm_bwd_slab<kSlabDvs>, smem0)) != cudaSuccess)
    return (int)e;
  const dim3 g0(ncol, nc, BH);
  mlstm_bwd_slab<kSlabX><<<g0, SLAB_NT, smem0, st>>>(DH, Q, CT, nS, gates, mS, X, xq, S, H, hd, L,
                                                nc, Sp, ntile, has_state);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const int smem1 = 1024 + RING + (int)sizeof(float) * (2 * ntile * TILE + 5 * TILE);
  if ((e = set_smem(mlstm_bwd_rows, smem1)) != cudaSuccess) return (int)e;
  mlstm_bwd_rows<<<ntile * nc * BH, NT, smem1, st>>>(Q, K_, V, DH, gates, xq, mS, rows, S, H,
                                                      hd, L, nc, Sp, ntile, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const int smem2 = 1024 + 2 * P2_PAIR + RAW_STAGES * P2_RAW +
                    (int)sizeof(float) * (2 * MAX_L + TILE + 4);
  if ((e = set_smem(mlstm_bwd_carry, smem2)) != cudaSuccess) return (int)e;
  mlstm_bwd_carry<<<dim3(ncol, ncol, BH), NT, smem2, st>>>(Q, DH, gates, CT,
                                                      nS, mS, rows, dCout, dnout, Cend, nend,
                                                      dCE, dnE, ddp, dmp, S, H, hd, L, nc, Sp,
                                                      scale, has_state);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const int smem3 = 1024 + RING + 2 * SLAB + (int)sizeof(float) * (2 * ntile * TILE + 6 * TILE);
  if ((e = set_smem(mlstm_bwd_dq, smem3)) != cudaSuccess) return (int)e;
  mlstm_bwd_dq<<<ncol * ntile * nc * BH, NT, smem3, st>>>(Q, K_, V, DH, gates, X, nS, mS, rows,
                                                     static_cast<bf16*>(dq), S, H, hd, L, nc,
                                                     Sp, ntile, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  // dq has read X: the buffer takes dCv
  mlstm_bwd_slab<kSlabDCv><<<g0, SLAB_NT, smem0, st>>>(V, K_, dCE, dnE, gates, mS, X, dlsc, S, H, hd,
                                                  L, nc, Sp, ntile, has_state);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  mlstm_bwd_slab<kSlabDvs><<<g0, SLAB_NT, smem0, st>>>(K_, nullptr, dCE, nullptr, gates, mS, DVS,
                                                  nullptr, S, H, hd, L, nc, Sp, ntile,
                                                  has_state);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const int smem4 = 1024 + RING + 4 * SLAB + (int)sizeof(float) * (5 * ntile * TILE + 2 * TILE);
  if ((e = set_smem(mlstm_bwd_dkdv, smem4)) != cudaSuccess) return (int)e;
  mlstm_bwd_dkdv<<<ncol * ntile * nc * BH, NT, smem4, st>>>(Q, K_, V, DH, gates, mS, rows, X, DVS,
                                                       dnE, static_cast<bf16*>(dk),
                                                       static_cast<bf16*>(dv), S, H, hd, L, nc,
                                                       Sp, ntile, scale);
  return (int)cudaGetLastError();
}

}  // namespace repro
