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
//   dC <- dC decay_c + GC_c, GC_c = qᵀ·(dh ⊙ inter / denom); dn likewise.
// (dh·(q C_c) is taken as q·X: X serves both the row scalars and dq, so the
// state takes four products, not five.)
//
// What bounds it on an H100: operations. At xlstm-350m's train microbatch
// ([4, 1024, 4, 512], L = 256) five products over the causal pairs (q·kᵀ and
// dh·vᵀ recomputed, ds'·k, ds'ᵀ·q, wᵀ·dh) are ~11 GFLOP in bf16 and four over
// the state (dh·Cᵀ, qᵀ·dh, v·dCEᵀ, (k ⊙ sc)·dCE) ~34 GFLOP in TF32, against
// ~184 MB of inputs, saved states and gradients: ~0.08 ms.
//
// Design: each pair tile is formed twice (the row sums need every key before
// a row's denominator is known) and then kept, in bf16, the very roundings
// wgmma reads as A operands; the column blocks of dq, dk and dv read those
// tiles and recompute nothing. Seven products over the pairs in all (the
// bound's five plus q·kᵀ and dh·vᵀ once more). Blocks are one warpgroup, or
// several where they share a resident operand (phase 0: four, 1: two);
// every sum has one order (no atomics), so two calls on the same inputs give
// the same bits.
// Launches, in order:
//   0. the state products, a block per (64 columns, chunk, B·H): it holds
//      its 64-row slab of the chunk's [hd][hd] matrix in shared memory
//      (128 KB at hd 512, its k order permuted: kperm); its four warpgroups
//      walk the chunk's 64-row tiles (tile w, w + 4, ..), streaming a 64
//      columns a step through a three-stage raw ring, each thread
//      building its TF32 A fragments from the raw bf16 rows in registers,
//      and write a·slabᵀ to a float32 [B·H, Sp, hd] scratch. Three uses: X = dh·C_cᵀ
//      with each row's Σ q·X and q·n_c over its columns (mlstm_bwd_slab_x,
//      before phase 1); dCv = v·dCE_cᵀ with each key's sc k·(dCv + dnE_c),
//      and (k ⊙ sc)·dCE_c (mlstm_bwd_slab_state, one launch for both, before
//      phase 4; the two read rows and columns of dCE_c: two slabs).
//   1. pairs, a block per (64-row query tile, chunk, B·H), two warpgroups:
//      the tile's q and dh held (all hd columns), warpgroup w taking key
//      tiles w, w + 2, .. up to the diagonal, two passes, S = q·kᵀ and P =
//      dh·vᵀ each pass: the first sums Σ w and Σ w ⊙ P and gives the row
//      scalars (denom, dqn, R, dinter·inter into a float32 scratch); the
//      second writes the tile's ds' and w / denom as bf16 64 x 64 tiles
//      ([B·H, nc, tiles of the lower triangle], 128-byte rows in the
//      128-byte swizzle, so a consumer copies a tile as it lies), each row's
//      Σ dlogD and each key's partial Σ dlogD over the block's rows (summed
//      in query-tile order by the gate phase).
//   2. carry in two launches: every GC_c (c >= 1) at once, a block per (64 x
//      128 tile of GC, chunk, B·H), TF32 wgmma over slabs transposed on the
//      way in, into the dCE slot of chunk c - 1 (and Gn_c into dnE's); then
//      the reverse recurrence elementwise, a block per 32 x 32 tile of dC
//      (one more for dn) and B·H, walking the chunks from the last: dCE_c
//      (rounded to TF32: phase 0's operand), dnE_c, and the partials of the
//      decay's gradient Σ dCE_c ⊙ C_c + dnE_c ⊙ n_c and of the state out's m
//      gradient.
//   3. dq, a block per (128 dq columns, query tile, chunk, B·H): (inter /
//      denom) X from phase 0's scratch, then ds'·k over the kept tiles.
//   4. dk / dv, a block per (128 columns, key tile, chunk, B·H), key tile 0
//      (the longest walk) first: ds'ᵀ·q and (w / denom)ᵀ·dh over the kept
//      tiles, wgmma reading them transposed (MN-major A); then the state
//      terms from phase 0's scratch.
// (64 columns where 128 do not divide hd.) Each chunk's saved C_c is read
// twice in all: by phase 0 (X) and, elementwise, by the recurrence (the
// decay's gradient); dCE_c is written once and read by phase 0's two later
// uses. Rows past S are zero in q, k, v, dh (zero fill) and give zeros.
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
constexpr int RAW_STAGES = 4;             // carry: raw stages (three steps ahead)
constexpr int PT = TILE * TILE;           // elements of a kept pair tile (8 KB in bf16)
constexpr int REC_NT = 256;               // the recurrence: a 32 x 32 tile of dC a block
constexpr int RT = 32;

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

// cp.async of 64 rows x 64 bf16 (columns col0..) of a [B, S, H, hd] tensor
// into a swizzled raw[64][128 bytes]; rows p0 + row0 + r, zero past the
// chunk and S
__device__ __forceinline__ void load_raw(uint32_t raw, const bf16* head, size_t rs, int p0,
                                         int row0, int L, int S, int col0, int tid) {
  for (int e = tid; e < TILE * 8; e += NT) {
    const int r = e >> 3, ch = e & 7, j = row0 + r, p = p0 + j;
    const bool ok = j < L && p < S;
    cp_async16(raw + swz128(r, ch), head + (size_t)(ok ? p : 0) * rs + col0 + ch * 8, ok);
  }
}

// a [64 rows][64 columns] bf16 tile (rows row0.., columns col0..) into a
// swizzled tile, zero past S
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* head, size_t rs, int p0,
                                          int row0, int S, int col0, int tid) {
  for (int e = tid; e < TILE * 8; e += NT) {
    const int r = e >> 3, ch = e & 7, p = p0 + row0 + r;
    cp_async16(dst + swz128(r, ch), head + (size_t)min(p, S - 1) * rs + col0 + ch * 8, p < S);
  }
}


// lower-triangle tile (query tile jt, key tile it <= jt) of a chunk's kept pairs
__device__ __forceinline__ int tri(int jt, int it) { return jt * (jt + 1) / 2 + it; }

// cp.async of a kept pair tile (8 KB, already in the 128-byte swizzle) as it lies
__device__ __forceinline__ void copy_tile(uint32_t dst, const bf16* src, int tid) {
  for (int e = tid; e < PT / 8; e += NT) cp_async16(dst + e * 16, src + e * 8, true);
}

// ---- phase 0: the state products, a chunk's matrix slab held in shared memory ----
enum { kSlabX = 0, kSlabDCv = 1, kSlabDvs = 2 };

constexpr int SLAB_WGS = 4;                        // warpgroups sharing a slab
constexpr int SLAB_NT = SLAB_WGS * NT;
constexpr int RAW_SLAB = 3;        // raw stages of a warpgroup's ring
constexpr int SLAB_WG = RAW_SLAB * SLAB;  // a warpgroup's ring: raw bf16 [64][64] each

// warpgroup wg's barrier (0 is __syncthreads')
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "r"(NT) : "memory");
}

// The k order within a 32-column group of phase 0's products: physical
// column pc sits at position 8 ((pc / 2) % 4) + pc / 8 + 4 (pc % 2), so that
// a thread's A fragments for the group's four k steps (columns tq and tq + 4
// of each, wgmma's tf32 layout) are the eight columns 8 tq .. 8 tq + 7 it
// reads with one 16-byte load.
__device__ __forceinline__ int kperm(int pc) {
  return 8 * ((pc >> 1) & 3) + (pc >> 3) + 4 * (pc & 1);
}

// Warpgroup wg's share (every SLAB_WGS-th 32-column group) of the block's slab of
// M(n0 + x, kk), x < 64, all kk, as hd / 32 swizzled [64][32] TF32 slabs in
// the kperm order: rows n0.. of M or, TRANS, its columns n0.., through
// registers, four groups a round trip.
template <bool TRANS>
__device__ __forceinline__ void load_slab(uint8_t* gdst, const float* m, int hd, int n0, int wg,
                                          int tid) {
  const int ND = hd / 32;
  for (int k0 = wg; k0 < ND; k0 += 4 * SLAB_WGS) {
    float4 x[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int e = tid + it * NT, ks = k0 + SLAB_WGS * u;
        if (ks >= ND) continue;
        if (TRANS) {  // 4 n at row kk of M: a warp reads 8 rows x 16 columns
          const int r = (e & 7) + 8 * ((e >> 5) & 3), c4 = 4 * (((e >> 3) & 3) + 4 * (e >> 7));
          x[u][it] = *reinterpret_cast<const float4*>(m + (size_t)(ks * 32 + r) * hd + n0 + c4);
        } else {      // 4 kk at row n of M
          const int r = e >> 3, ch = e & 7;
          x[u][it] = *reinterpret_cast<const float4*>(m + (size_t)(n0 + r) * hd + ks * 32 + ch * 4);
        }
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int e = tid + it * NT, ks = k0 + SLAB_WGS * u;
        if (ks >= ND) continue;
        uint8_t* d = gdst + ks * SLAB;
        const float v4[4] = {x[u][it].x, x[u][it].y, x[u][it].z, x[u][it].w};
        if (TRANS) {
          const int r = (e & 7) + 8 * ((e >> 5) & 3), c4 = 4 * (((e >> 3) & 3) + 4 * (e >> 7));
#pragma unroll
          for (int i = 0; i < 4; ++i) *reinterpret_cast<float*>(d + f32_at(c4 + i, kperm(r))) = v4[i];
        } else {
          const int r = e >> 3, ch = e & 7;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            *reinterpret_cast<float*>(d + f32_at(r, kperm(4 * ch + i))) = v4[i];
        }
      }
  }
}

// A block (column block ct of ncol, chunk c, head bh) of one use, SLAB_WGS
// warpgroups: out[bh, p0 + j, n0 + x] = Σ_kk a[j, kk] M(n0 + x, kk) for every
// row j of chunk c, in TF32. The block loads its [64 n][hd kk] slab of the
// chunk's M once; warpgroup w walks the chunk's 64-row tiles w, w + SLAB_WGS,
// .., each streaming a 64 columns a step. M(n, kk) is M_c[n][kk] (kSlabDCv)
// or M_c[kk][n].
//   kSlabX:   a = dh, M = CT (C_cᵀ), so X = dh·C_cᵀ; part [B·H, 2, ncol, Sp]
//             gets each row's Σ q·X and Σ q·n_c (vec = nS) over the block's
//             columns (b2 = q). A chunk with no start state gives zeros.
//   kSlabDCv: a = v, M = dCE, so dCv = v·dCE_cᵀ; part [B·H, ncol, Sp] gets
//             each key's sc Σ k·(dCv + dnE_c) (b2 = k, vec = dnE).
//   kSlabDvs: a = k ⊙ sc, M = dCE, so (k ⊙ sc)·dCE_c; no part.
// sc_m = exp(F_L - F_m + ig_m - m_next), the key's weight in the state update.
template <int MODE>
__device__ __forceinline__ void slab_block(const bf16* __restrict__ a, const bf16* __restrict__ b2,
         const float* __restrict__ M, const float* __restrict__ vec,
         const float* __restrict__ gates, const float* __restrict__ mS,
         float* __restrict__ out, float* __restrict__ part, int S, int H, int hd, int L,
         int nc, int Sp, int ntile, int has_state, int ct, int c, int bh, int ncol) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_addr(smem_raw));
  const int ND = hd / 32, NK = hd / 64;
  const int wg = threadIdx.x / NT, tid = threadIdx.x % NT;
  // the warpgroup's ring: RAW_SLAB stages of the raw bf16 [64][64]
  const uint32_t stg = base + ND * SLAB + wg * SLAB_WG;
  float* sVec = reinterpret_cast<float*>(gbase + ND * SLAB + SLAB_WGS * SLAB_WG);  // [64]

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
  // sc_m = exp(F_L - F_m + ig_m - m_next), key m's weight in the state update
  const float* gF = gates + (size_t)bh * 3 * Sp + p0;
  const float m_c = mS[(size_t)bh * nc + c];
  const float FL = gF[L - 1];
  const float m_next = fmaxf(FL + m_c, gF[Sp + L - 1]);
  auto sc_of = [&](int m) {
    return m < L ? expf(((FL - gF[m]) + gF[2 * Sp + m]) - m_next) : 0.f;
  };

  // a streamed through the warpgroup's ring, 64 columns a step (RAW_SLAB - 1
  // steps ahead); each thread builds its TF32 A fragments from the raw rows
  // (rows r_lo, r_lo + 8; columns 8 tq .. 8 tq + 7 of each 32-column group)
  const int T = ((ntile - wg + SLAB_WGS - 1) / SLAB_WGS) * NK;
  auto raw_at = [&](int t) { return stg + (t % RAW_SLAB) * SLAB; };
  auto tile_of = [&](int t) { return wg + SLAB_WGS * (t / NK); };
  auto issue = [&](int t) {
    if (t < T) load_raw(raw_at(t), a + head, rs, p0, tile_of(t) * TILE, L, S, (t % NK) * 64, tid);
    cp_async_commit();
  };
  for (int t = 0; t < RAW_SLAB - 1; ++t) issue(t);
  load_slab<MODE != kSlabDCv>(gbase, mat, hd, n0, wg, tid);  // the slab, once
  if (threadIdx.x < TILE)
    sVec[threadIdx.x] = MODE != kSlabDvs ? vec[((size_t)bh * nc + c) * hd + n0 + threadIdx.x] : 0.f;
  fence_async_smem();
  __syncthreads();
  int mul_tile = -1;  // (k ⊙ sc): the sc of this thread's two rows, for tile mul_tile
  float mul[2] = {1.f, 1.f};
  float acc[32];
  for (int t = 0; t < T; ++t) {
    const int jt = tile_of(t), ks = t % NK;
    cp_async_wait<RAW_SLAB - 2>();  // step t's raw columns
    wg_sync(wg);                    // every thread's copy landed; step t - 1 done
    issue(t + RAW_SLAB - 1);        // into the stage step t - 1 read
    if (MODE == kSlabDvs && jt != mul_tile) {
      mul_tile = jt;
      mul[0] = sc_of(jt * TILE + r_lo);
      mul[1] = sc_of(jt * TILE + r_lo + 8);
    }
    const uint8_t* rb = gbase + (raw_at(t) - base);
    uint32_t af[2][4][4];  // [32-column group][k step][register]
#pragma unroll
    for (int grp = 0; grp < 2; ++grp) {
      const uint4 w0 = *reinterpret_cast<const uint4*>(rb + swz128(r_lo, 4 * grp + tq));
      const uint4 w1 = *reinterpret_cast<const uint4*>(rb + swz128(r_lo + 8, 4 * grp + tq));
      const bf16* h0 = reinterpret_cast<const bf16*>(&w0);
      const bf16* h1 = reinterpret_cast<const bf16*>(&w1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {  // columns tq (x 0) and tq + 4 (x 1) of the k step
          const float f0 = __bfloat162float(h0[2 * kk + x]), f1 = __bfloat162float(h1[2 * kk + x]);
          af[grp][kk][2 * x] = __float_as_uint(MODE == kSlabDvs ? to_tf32(f0 * mul[0]) : f0);
          af[grp][kk][2 * x + 1] = __float_as_uint(MODE == kSlabDvs ? to_tf32(f1 * mul[1]) : f1);
        }
      }
    }
    wgmma_fence();
#pragma unroll
    for (int grp = 0; grp < 2; ++grp)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_tf32_rs_n64(acc, af[grp][kk], desc_k(base + (2 * ks + grp) * SLAB, kk),
                          ks > 0 || grp > 0 || kk > 0);
    wgmma_commit();
    // the epilogue's b2 values, loaded while the tile's last wgmma runs (zero
    // past the chunk and S)
    float2 b2v[16];
    if (MODE != kSlabDvs && ks == NK - 1) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int j = jt * TILE + acc_row(i, r_lo), p = p0 + j;
        b2v[i >> 1] = j < L && p < S ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                           b2 + head + (size_t)p * rs + n0 + acc_col(i, tq)))
                                     : make_float2(0.f, 0.f);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int grp = 0; grp < 2; ++grp)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs_u(af[grp][kk]);  // read by wgmma until here
    if (ks != NK - 1) continue;
    fence_regs(acc);
    // ---- tile jt is done: write it, and the partials over the block's columns ----------
    float pa[2] = {0.f, 0.f}, pb[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int hi = (i >> 1) & 1, j = jt * TILE + acc_row(i, r_lo);
      const int col = acc_col(i, tq);
      if (j >= L) continue;
      *reinterpret_cast<float2*>(o + (size_t)j * hd + col) = make_float2(acc[i], acc[i + 1]);
      if (MODE == kSlabDvs) continue;
      const float2 x2 = b2v[i >> 1];
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
          *part_at(0, j) = sc_of(j) * pa[x];
        }
      }
    }
  }
  cp_async_wait<0>();
}

// grid (hd / 64, nc, B·H): X = dh·C_cᵀ, before phase 1
__global__ void __launch_bounds__(SLAB_NT)
mlstm_bwd_slab_x(const bf16* __restrict__ dh, const bf16* __restrict__ q,
         const float* __restrict__ CT, const float* __restrict__ nS,
         const float* __restrict__ gates, const float* __restrict__ mS, float* __restrict__ X,
         float* __restrict__ xq, int S, int H, int hd, int L, int nc, int Sp, int ntile,
         int has_state) {
  slab_block<kSlabX>(dh, q, CT, nS, gates, mS, X, xq, S, H, hd, L, nc, Sp, ntile, has_state,
                     blockIdx.x, blockIdx.y, blockIdx.z, gridDim.x);
}

// grid (hd / 64, nc, 2 B·H): dCv = v·dCE_cᵀ (z < B·H), then (k ⊙ sc)·dCE_c, in
// one launch (one tail, not two)
__global__ void __launch_bounds__(SLAB_NT)
mlstm_bwd_slab_state(const bf16* __restrict__ v, const bf16* __restrict__ k,
         const float* __restrict__ dCE, const float* __restrict__ dnE,
         const float* __restrict__ gates, const float* __restrict__ mS, float* __restrict__ dCv,
         float* __restrict__ dlsc, float* __restrict__ dvs, int S, int H, int hd, int L, int nc,
         int Sp, int ntile) {
  const int BH = gridDim.z / 2;
  if (blockIdx.z < BH)
    slab_block<kSlabDCv>(v, k, dCE, dnE, gates, mS, dCv, dlsc, S, H, hd, L, nc, Sp, ntile, 1,
                         blockIdx.x, blockIdx.y, blockIdx.z, gridDim.x);
  else
    slab_block<kSlabDvs>(k, nullptr, dCE, nullptr, gates, mS, dvs, nullptr, S, H, hd, L, nc, Sp,
                         ntile, 1, blockIdx.x, blockIdx.y, blockIdx.z - BH, gridDim.x);
}

// ---- phase 1: pairs (the row scalars, then the kept tiles) -------------------------
// one block per (query tile, chunk, B·H), longest tiles first, two
// warpgroups: the tile's q and dh (all hd columns) loaded once and held;
// warpgroup w takes the key tiles w, w + 2, .. up to the diagonal, k and v
// streamed a 64-column slab a step. Each tile's S and P, once formed, go to
// sp [B·H, nc, tiles, 2, 4096] float32 in the order the accumulators hold
// them (the thread that wrote them reads them back, after the row scalars:
// in L2, not formed again). The tiles of (jt, it) go to
// pt[x][bh][c][tri(jt, it)], x = 0: ds', 1: w / denom; row r, column col at
// byte swz128(r, col / 8) + (col % 8) * 2 of the tile. cols [B·H, ntile,
// Sp]: query tile jt's part of each key's Σ dlogD (zero past its diagonal).
// A row's sums over the two warpgroups' key tiles add in one order (w 0,
// then w 1).
constexpr int PAIR_NT = 2 * NT;

__global__ void __launch_bounds__(PAIR_NT)
mlstm_bwd_pairs(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
         const bf16* __restrict__ dh, const float* __restrict__ gates,
         const float* __restrict__ xq, const float* __restrict__ mS,
         float* __restrict__ rows, float* __restrict__ cols, bf16* __restrict__ pt,
         float* __restrict__ sp, int S, int H, int hd, int L, int nc, int Sp, int ntile,
         float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_addr(smem_raw));
  const int NS = hd / TILE;
  const uint32_t sQ = base, sDH = base + NS * SLAB;  // the query tile: NS slabs each
  const uint32_t ring = base + 2 * NS * SLAB;        // 2 stages x 2 warpgroups x (k, v)
  float* sF = reinterpret_cast<float*>(gbase + 2 * NS * SLAB + 8 * SLAB);  // [ntile * 64]
  float* sIg = sF + ntile * TILE;
  float* sMj = sIg + ntile * TILE;  // [64] per query row
  float* sInter = sMj + TILE;
  float* sEmj = sInter + TILE;
  float* sQn = sEmj + TILE;         // q·n_c
  float* sHx = sQn + TILE;          // q·X = dh·(q C_c)
  float* sDen = sHx + TILE;
  float* sDqn = sDen + TILE;
  float* sW1 = sDqn + TILE;         // [64] warpgroup 1's row sums: Σ w,
  float* sP1 = sW1 + TILE;          // Σ w ⊙ P,
  float* sR1 = sP1 + TILE;          // Σ dlogD
  float* sCol = sR1 + TILE;         // [2 warpgroups][4 warps][64 keys]

  int idx = blockIdx.x;
  const int BH = gridDim.x / (nc * ntile);
  const int bh = idx % BH;
  idx /= BH;
  const int c = idx % nc, jt = ntile - 1 - idx / nc;
  const int b = bh / H, hh = bh - b * H;
  const int ptid = threadIdx.x, wg = ptid / NT, tid = ptid % NT;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int p0 = c * L, row0 = jt * TILE;
  const size_t rs = (size_t)H * hd;
  const size_t head = (size_t)b * S * rs + (size_t)hh * hd;
  const float* gF = gates + (size_t)bh * 3 * Sp + p0;
  const float m_c = mS[(size_t)bh * nc + c];
  const int nkeys = (jt + 1) * TILE;
  float* colp = cols + ((size_t)bh * ntile + jt) * Sp + p0;

  // the query tile's q and dh, once (rows past S zero)
  for (int e = ptid; e < NS * TILE * 8; e += PAIR_NT) {
    const int sl = e / (TILE * 8), r = (e >> 3) & (TILE - 1), ch = e & 7, p = p0 + row0 + r;
    const size_t at = head + (size_t)min(p, S - 1) * rs + sl * TILE + ch * 8;
    cp_async16(sQ + sl * SLAB + swz128(r, ch), q + at, p < S);
    cp_async16(sDH + sl * SLAB + swz128(r, ch), dh + at, p < S);
  }
  cp_async_commit();
  // step t: key tile pair t / NS (warpgroup w: key tile 2 (t / NS) + w), column slab t % NS
  const int U = (jt + 2) / 2 * NS;
  auto issue = [&](int t) {
    if (t < U) {
      const int ip = t / NS, sl = t % NS;
      for (int w = 0; w < 2; ++w) {
        const int it = 2 * ip + w;
        if (it > jt) continue;
        const uint32_t st = ring + ((t & 1) * 2 + w) * 2 * SLAB;
        for (int e = ptid; e < TILE * 8; e += PAIR_NT) {
          const int r = e >> 3, ch = e & 7, pk = p0 + it * TILE + r;
          const size_t at = head + (size_t)min(pk, S - 1) * rs + sl * TILE + ch * 8;
          cp_async16(st + swz128(r, ch), k + at, pk < S);
          cp_async16(st + SLAB + swz128(r, ch), v + at, pk < S);
        }
      }
    }
    cp_async_commit();
  };
  issue(0);
  for (int i = ptid; i < nkeys; i += PAIR_NT) {
    sF[i] = i < L ? gF[i] : 0.f;
    sIg[i] = i < L ? gF[2 * Sp + i] : kNegInf;
  }
  for (int m = nkeys + ptid; m < L; m += PAIR_NT) colp[m] = 0.f;
  if (ptid < TILE) {
    const int j = row0 + ptid;
    if (j < L) {
      const float m_inter = gF[j] + m_c;
      const float mj = fmaxf(m_inter, gF[Sp + j]);
      sMj[ptid] = mj;
      sInter[ptid] = expf(m_inter - mj);
      sEmj[ptid] = expf(-mj);
    } else {
      sMj[ptid] = 0.f;
      sInter[ptid] = 0.f;
      sEmj[ptid] = 1.f;
    }
    sDen[ptid] = 1.f;
    sDqn[ptid] = 0.f;
    // phase 0's partials over the column blocks (all loaded, then summed in
    // column order)
    const int ncol = hd / TILE;
    float hv[8], qv[8];
#pragma unroll
    for (int ct = 0; ct < 8; ++ct) {
      const bool ok = ct < ncol && j < L;
      hv[ct] = ok ? xq[(((size_t)bh * 2 + 0) * ncol + ct) * Sp + p0 + j] : 0.f;
      qv[ct] = ok ? xq[(((size_t)bh * 2 + 1) * ncol + ct) * Sp + p0 + j] : 0.f;
    }
    float hx = 0.f, qn = 0.f;
#pragma unroll
    for (int ct = 0; ct < 8; ++ct) {
      if (ct < ncol) {
        hx += hv[ct];
        qn += qv[ct];
      }
    }
    sHx[ptid] = hx * scale;
    sQn[ptid] = qn * scale;
  }

  const int r_lo = warp * 16 + g;
  const int ntri = ntile * (ntile + 1) / 2;
  bf16* tile_ds = pt + ((size_t)bh * nc + c) * ntri * PT;
  bf16* tile_wd = tile_ds + (size_t)BH * nc * ntri * PT;
  // a tile's S and P as this warpgroup's accumulators hold them: [2][8][128 threads][4]
  float* keep = sp + ((size_t)bh * nc + c) * ntri * 2 * PT;
  float sacc[32], pacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.f;
  float wsum[2] = {0.f, 0.f}, wp[2] = {0.f, 0.f}, rsum[2] = {0.f, 0.f};

  // ---- a. per key tile: S = q·kᵀ, P = dh·vᵀ; Σ w and Σ w ⊙ P; S and P kept ---------------
  for (int t = 0; t < U; ++t) {
    const int s = t % NS, it = 2 * (t / NS) + wg;
    const bool active = it <= jt;
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    issue(t + 1);
    if (!active) continue;
    const uint32_t sk = ring + ((t & 1) * 2 + wg) * 2 * SLAB, sv = sk + SLAB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(sacc, desc_k(sQ + s * SLAB, kk), desc_k(sk, kk), s > 0 || kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(pacc, desc_k(sDH + s * SLAB, kk), desc_k(sv, kk), s > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);
    fence_regs(pacc);
    if (s != NS - 1) continue;
    float4* kp = reinterpret_cast<float4*>(keep + (size_t)tri(jt, it) * 2 * PT);
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      kp[x * NT + tid] = make_float4(sacc[4 * x], sacc[4 * x + 1], sacc[4 * x + 2], sacc[4 * x + 3]);
      kp[(8 + x) * NT + tid] =
          make_float4(pacc[4 * x], pacc[4 * x + 1], pacc[4 * x + 2], pacc[4 * x + 3]);
    }
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

  // ---- b. the row scalars ---------------------------------------------------------------
#pragma unroll
  for (int x = 0; x < 2; ++x) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      wsum[x] += __shfl_xor_sync(0xffffffffu, wsum[x], o);
      wp[x] += __shfl_xor_sync(0xffffffffu, wp[x], o);
    }
  }
  if (wg == 1 && tq == 0) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      sW1[r_lo + 8 * x] = wsum[x];
      sP1[r_lo + 8 * x] = wp[x];
    }
  }
  __syncthreads();
  if (wg == 0 && tq == 0) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = r_lo + 8 * x, j = row0 + r;
      if (j >= L) continue;
      const float inter = sInter[r], lo = sEmj[r], qn_c = sQn[r], h_x = sHx[r];
      const float qn = inter * qn_c + (wsum[x] + sW1[r]);
      const float aq = fabsf(qn);
      const float denom = fmaxf(aq, lo);
      const float dhh = inter * h_x + (wp[x] + sP1[r]);
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
      sDen[r] = denom;
      sDqn[r] = dqn;
    }
  }
  __syncthreads();

  // ---- c. each of the warpgroup's tiles (jt, it), from the kept S and P: ds', w / denom
  // kept in bf16; Σ dlogD by row and by key
  float* wcol = sCol + wg * 4 * TILE;
  for (int it = wg; it <= jt; it += 2) {
    const float4* kp = reinterpret_cast<const float4*>(keep + (size_t)tri(jt, it) * 2 * PT);
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const float4 a = kp[x * NT + tid], b2 = kp[(8 + x) * NT + tid];
      sacc[4 * x] = a.x, sacc[4 * x + 1] = a.y, sacc[4 * x + 2] = a.z, sacc[4 * x + 3] = a.w;
      pacc[4 * x] = b2.x, pacc[4 * x + 1] = b2.y, pacc[4 * x + 2] = b2.z, pacc[4 * x + 3] = b2.w;
    }
    uint8_t* ods = reinterpret_cast<uint8_t*>(tile_ds + (size_t)tri(jt, it) * PT);
    uint8_t* owd = reinterpret_cast<uint8_t*>(tile_wd + (size_t)tri(jt, it) * PT);
    float colv[16];
#pragma unroll
    for (int y = 0; y < 16; ++y) colv[y] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int hi = (i >> 1) & 1, r = acc_row(i, r_lo), jl = row0 + r;
      float ds[2], wd[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int il = it * TILE + acc_col(i + x, tq);
        ds[x] = wd[x] = 0.f;
        if (il <= jl && jl < L) {
          const float dd = expf(((sF[jl] - sF[il]) + sIg[il]) - sMj[r]);
          const float tt = pacc[i + x] / sDen[r] + sDqn[r];
          const float w = sacc[i + x] * scale * dd;
          const float dl = w * tt;
          ds[x] = dd * tt;
          wd[x] = w / sDen[r];
          rsum[hi] += dl;
          colv[(i >> 2) * 2 + x] += dl;
        }
      }
      const uint32_t at = swz128(r, i >> 2) + tq * 4;  // column acc_col(i, tq), even
      *reinterpret_cast<uint32_t*>(ods + at) = pack_bf16(ds[0], ds[1]);
      *reinterpret_cast<uint32_t*>(owd + at) = pack_bf16(wd[0], wd[1]);
    }
    // each key's sum over the tile's 64 rows: lanes of one tq, then the warps in order
#pragma unroll
    for (int y = 0; y < 16; ++y) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) colv[y] += __shfl_xor_sync(0xffffffffu, colv[y], o);
    }
    wg_sync(wg);  // the warpgroup's previous tile's sums are read
    if (g == 0) {
#pragma unroll
      for (int y = 0; y < 16; ++y) wcol[warp * TILE + 8 * (y >> 1) + 2 * tq + (y & 1)] = colv[y];
    }
    wg_sync(wg);
    if (tid < TILE && it * TILE + tid < L)
      colp[it * TILE + tid] = ((wcol[tid] + wcol[TILE + tid]) + wcol[2 * TILE + tid]) +
                              wcol[3 * TILE + tid];
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    rsum[x] += __shfl_xor_sync(0xffffffffu, rsum[x], 1);
    rsum[x] += __shfl_xor_sync(0xffffffffu, rsum[x], 2);
  }
  if (wg == 1 && tq == 0) {
#pragma unroll
    for (int x = 0; x < 2; ++x) sR1[r_lo + 8 * x] = rsum[x];
  }
  __syncthreads();
  if (wg == 0 && tq == 0) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = r_lo + 8 * x, j = row0 + r;
      if (j < L) rows[((size_t)bh * NR + kRowsum) * Sp + p0 + j] = rsum[x] + sR1[r];
    }
  }
}

// ---- phase 2a: every GC_c at once -------------------------------------------------
// grid (hd / (64 NE) column blocks e, hd / 64 rows d, (nc - 1)·B·H): GC_c =
// Σ_i q_i ⊗ dh_i scale inter_i / denom_i over chunk c >= 1's rows (TF32
// wgmma over slabs transposed on the way in, KI rows a step), written
// unrounded to dCE's slot c - 1; the et = 0 blocks write Gn_c = Σ_i q_i
// scale dqn_i inter_i to dnE's slot c - 1.
template <int NE>
__global__ void __launch_bounds__(NT)
mlstm_bwd_carry_gc(const bf16* __restrict__ q, const bf16* __restrict__ dh,
          const float* __restrict__ gates, const float* __restrict__ mS,
          const float* __restrict__ rows, float* __restrict__ dCE, float* __restrict__ dnE,
          int S, int H, int hd, int L, int nc, int Sp, float scale) {
  constexpr int PAIR = (1 + NE) * TILE * 128;  // a step's TF32 slabs: [64 d][KI], NE x [64 e][KI]
  constexpr int RAWB = (1 + NE) * KI * 128;  // a step's raw bf16 rows: q [KI][64], dh [KI][64 NE]
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t raw = base + 2 * PAIR;
  float* sCoef = reinterpret_cast<float*>(gbase + 2 * PAIR + RAW_STAGES * RAWB);
  float* sW2 = sCoef + MAX_L;

  const int BH = gridDim.z / (nc - 1);
  const int et = blockIdx.x, dt = blockIdx.y, bh = blockIdx.z % BH, c = 1 + blockIdx.z / BH;
  const int b = bh / H, hh = bh - b * H;
  const int e0 = et * TILE * NE, d0 = dt * TILE, p0 = c * L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const float* gF = gates + (size_t)bh * 3 * Sp;
  const float* gM = gF + Sp;
  const size_t rs = (size_t)H * hd;
  const bf16* qb = q + (size_t)b * S * rs + (size_t)hh * hd + d0;
  const bf16* db = dh + (size_t)b * S * rs + (size_t)hh * hd + e0;
  const float* rw = rows + (size_t)bh * NR * Sp;

  const int T = (L + KI - 1) / KI;
  auto issue = [&](int t) {  // rows t * KI.. of the chunk: q, then dh's NE 64-column halves
    if (t < T) {
      const int i0 = t * KI;
      const uint32_t rq = raw + (t % RAW_STAGES) * RAWB;
      for (int e = tid; e < (1 + NE) * KI * 8; e += NT) {
        const int part = e / (KI * 8), r = (e >> 3) & (KI - 1), ch = e & 7, i = i0 + r;
        const int p = p0 + i;
        const bool ok = i < L && p < S;
        const size_t at = (size_t)(ok ? p : 0) * rs + ch * 8;
        cp_async16(rq + part * KI * 128 + swz128(r, ch),
                   part == 0 ? qb + at : db + at + (part - 1) * TILE, ok);
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < RAW_STAGES - 1; ++t) issue(t);

  // ---- the rows' weights: q·coef into dC, q·w2 into dn -------------------------------
  const float m_c = mS[(size_t)bh * nc + c];
  for (int i = tid; i < T * KI; i += NT) {
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
  float acc[NE][32];
#pragma unroll
  for (int h = 0; h < NE; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  float np[2][8];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < 8; ++e) np[u][e] = 0.f;
  for (int t = 0; t < T; ++t) {
    cp_async_wait<RAW_STAGES - 2>();
    __syncthreads();
    issue(t + RAW_STAGES - 1);
    const uint8_t* rq = gbase + (raw - base) + (t % RAW_STAGES) * RAWB;
    uint8_t* A = gbase + (t & 1) * PAIR;
    const float cf = sCoef[t * KI + lane], w2 = sW2[t * KI + lane];
    // transposed on the way: lane = row i, the warp's 16-byte chunks of it
#pragma unroll
    for (int u = 0; u < 2 * (1 + NE); ++u) {
      const int part = u >> 1, ch = warp + 4 * (u & 1);  // part 0: q, then dh's halves
      const uint4 xr = *reinterpret_cast<const uint4*>(rq + part * KI * 128 + swz128(lane, ch));
      const bf16* xh = reinterpret_cast<const bf16*>(&xr);
      uint8_t* dst = A + part * TILE * 128;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = ch * 8 + e;
        const uint32_t off = swz128(r, lane >> 2) + (lane & 3) * 4;
        const float x = __bfloat162float(xh[e]);
        if (part == 0) {
          np[u][e] = fmaf(x, w2, np[u][e]);
          *reinterpret_cast<float*>(dst + off) = to_tf32(x * cf);
        } else {
          *reinterpret_cast<float*>(dst + off) = x;
        }
      }
    }
    fence_async_smem();
    __syncthreads();
    const uint32_t sA = base + (t & 1) * PAIR;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < NE; ++h)
        wgmma_tf32_n64(acc[h], desc_k(sA, kk), desc_k(sA + (1 + h) * TILE * 128, kk), 1);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < NE; ++h) fence_regs(acc[h]);
  cp_async_wait<0>();
  const int ra = warp * 16 + g;
  float* gc = dCE + ((size_t)bh * nc + c - 1) * hd * hd;
#pragma unroll
  for (int h = 0; h < NE; ++h)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int d = d0 + ra + 8 * ((i >> 1) & 1), e = e0 + h * TILE + 8 * (i >> 2) + 2 * tq;
      *reinterpret_cast<float2*>(gc + (size_t)d * hd + e) = make_float2(acc[h][i], acc[h][i + 1]);
    }
  if (et != 0) return;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < 8; ++e) np[u][e] = warp_sum(np[u][e]);
  if (lane == 0) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dnE[((size_t)bh * nc + c - 1) * hd + d0 + (warp + 4 * u) * 8 + e] = np[u][e];
  }
}

// ---- phase 2b: the reverse recurrence, elementwise ---------------------------------
// grid ((hd / 32)^2 + 1, B·H): a 32 x 32 tile of dC a block (the last block:
// dn), chunks from the last. dCE_c = dC (rounded to TF32), dC <- dC decay_c +
// GC_c (dCE's slot c - 1, overwritten next); ddp[bh, c, part] its share of
// Σ dCE_c ⊙ C_c + dnE_c ⊙ n_c, dmp[bh, part] of Σ dC ⊙ C_out + dn ⊙ n_out.
__global__ void __launch_bounds__(REC_NT)
mlstm_bwd_carry_rec(const float* __restrict__ gates, const float* __restrict__ CT,
          const float* __restrict__ nS, const float* __restrict__ mS,
          const float* __restrict__ dCout, const float* __restrict__ dnout,
          const float* __restrict__ Cend, const float* __restrict__ nend,
          float* __restrict__ dCE, float* __restrict__ dnE, float* __restrict__ ddp,
          float* __restrict__ dmp, int hd, int L, int nc, int Sp, int has_state) {
  __shared__ float sT[RT][RT + 1];
  __shared__ float sRed[REC_NT / 32];
  const int part = blockIdx.x, NP = gridDim.x, bh = blockIdx.y, nt = hd / RT;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const bool isN = part == NP - 1;
  const int d0 = (part / nt) * RT, e0 = (part % nt) * RT;
  const float* gF = gates + (size_t)bh * 3 * Sp;
  const size_t hd2 = (size_t)hd * hd;
  auto block_sum = [&](float x) {  // in one order
    x = warp_sum(x);
    __syncthreads();
    if (tx == 0) sRed[ty] = x;
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < REC_NT / 32; ++w) s += sRed[w];
    return s;
  };
  // this thread's elements: dC (d0 + ty + 8 r, e0 + tx), or dn (tid + 256 r)
  float E[4];
  float dm = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    E[r] = 0.f;
    if (isN) {
      const int d = tid + REC_NT * r;
      if (r < 2 && d < hd && dnout != nullptr) {
        E[r] = dnout[(size_t)bh * hd + d];
        dm = fmaf(E[r], nend[(size_t)bh * hd + d], dm);
      }
    } else if (dCout != nullptr) {
      const size_t at = bh * hd2 + (size_t)(d0 + ty + 8 * r) * hd + e0 + tx;
      E[r] = dCout[at];
      dm = fmaf(E[r], Cend[at], dm);
    }
  }
  dm = block_sum(dm);
  if (tid == 0) dmp[(size_t)bh * NP + part] = dm;
  for (int c = nc - 1; c >= 0; --c) {
    const size_t slot = (size_t)bh * nc + c;
    float dd = 0.f;
    if (isN) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int d = tid + REC_NT * r;
        if (d >= hd) continue;
        dnE[slot * hd + d] = E[r];
        dd = fmaf(E[r], nS[slot * hd + d], dd);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        dCE[slot * hd2 + (size_t)(d0 + ty + 8 * r) * hd + e0 + tx] = to_tf32(E[r]);
        sT[ty + 8 * r][tx] = E[r];
      }
      __syncthreads();
      if (has_state || c > 0) {  // C_c = CT_c transposed: read CT's rows e
        const float* ct = CT + slot * hd2;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          dd = fmaf(sT[tx][ty + 8 * r], ct[(size_t)(e0 + ty + 8 * r) * hd + d0 + tx], dd);
      }
    }
    dd = block_sum(dd);  // (its first barrier also frees sT)
    if (tid == 0) ddp[slot * NP + part] = dd;
    if (c == 0) break;
    const float m_c = mS[slot], FL = gF[c * L + L - 1];
    const float decay = expf((FL + m_c) - fmaxf(FL + m_c, gF[Sp + c * L + L - 1]));
    if (isN) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int d = tid + REC_NT * r;
        if (d < hd) E[r] = fmaf(E[r], decay, dnE[(slot - 1) * hd + d]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        E[r] = fmaf(E[r], decay, dCE[(slot - 1) * hd2 + (size_t)(d0 + ty + 8 * r) * hd + e0 + tx]);
    }
  }
}

// ---- phase 3: dq from the kept tiles ----------------------------------------------
// one block per (64 NH dq columns, B·H, chunk, query tile), longest tiles
// first: acc = (inter / denom) X, then per key tile up to the diagonal
// acc += ds'(jt, it)·k (A: the kept tile, K-major; B: k, MN-major); dq =
// scale (acc + dqn inter n_c)
template <int NH>
__global__ void __launch_bounds__(NT)
mlstm_bwd_dq(const bf16* __restrict__ k, const bf16* __restrict__ pt,
       const float* __restrict__ gates, const float* __restrict__ X,
       const float* __restrict__ nS, const float* __restrict__ mS,
       const float* __restrict__ rows, bf16* __restrict__ dq, int S, int H, int hd, int L,
       int nc, int Sp, int ntile, float scale) {
  constexpr int STG = (1 + NH) * SLAB;  // a stage (of 2): the ds' tile, NH slabs of k
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_addr(smem_raw));
  float* sCx = reinterpret_cast<float*>(gbase + 2 * STG);  // [64] inter / denom
  float* sDi = sCx + TILE;                                  // [64] dqn inter
  float* sNq = sDi + TILE;                                  // [64 NH] n_c of the columns

  const int ncb = hd / (TILE * NH);
  int idx = blockIdx.x;
  const int ct = idx % ncb;
  idx /= ncb;
  const int BH = gridDim.x / (ncb * nc * ntile);
  const int bh = idx % BH;
  idx /= BH;
  const int c = idx % nc, jt = ntile - 1 - idx / nc;
  const int b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int p0 = c * L, row0 = jt * TILE, d0 = ct * TILE * NH;
  const size_t rs = (size_t)H * hd;
  const size_t head = (size_t)b * S * rs + (size_t)hh * hd;
  const float* gF = gates + (size_t)bh * 3 * Sp + p0;
  const float* rw = rows + (size_t)bh * NR * Sp + p0;
  const float m_c = mS[(size_t)bh * nc + c];
  const int ntri = ntile * (ntile + 1) / 2;
  const bf16* tiles = pt + ((size_t)bh * nc + c) * ntri * PT;
  if (tid < TILE) {
    const int j = row0 + tid;
    float inter = 0.f, den = 1.f, dqn = 0.f;
    if (j < L) {
      const float m_inter = gF[j] + m_c;
      inter = expf(m_inter - fmaxf(m_inter, gF[Sp + j]));
      den = rw[kDenom * Sp + j];
      dqn = rw[kDqn * Sp + j];
    }
    sCx[tid] = inter / den;
    sDi[tid] = dqn * inter;
  }
  for (int x = tid; x < TILE * NH; x += NT) sNq[x] = nS[((size_t)bh * nc + c) * hd + d0 + x];
  auto issue = [&](int it) {
    if (it <= jt) {
      const uint32_t st = base + (it & 1) * STG;
      copy_tile(st, tiles + (size_t)tri(jt, it) * PT, tid);
#pragma unroll
      for (int h = 0; h < NH; ++h)
        load_tile(st + (1 + h) * SLAB, k + head, rs, p0, it * TILE, S, d0 + h * TILE, tid);
    }
    cp_async_commit();
  };
  issue(0);
  __syncthreads();

  // ---- a. (inter / denom) X over the dq columns, from phase 0 ---------------------------
  const int r_lo = warp * 16 + g;
  const float* xr = X + ((size_t)bh * Sp + p0) * hd + d0;
  float acc[NH][32];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = acc_row(i, r_lo), j = row0 + r;
      acc[h][i] = j < L ? xr[(size_t)j * hd + h * TILE + acc_col(i, tq)] * sCx[r] : 0.f;
    }

  // ---- b. per key tile: acc += ds'·k ----------------------------------------------------
  for (int it = 0; it <= jt; ++it) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    issue(it + 1);
    const uint32_t st = base + (it & 1) * STG;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < NH; ++h)
        wgmma_ss_n64_t<0, 1>(acc[h], desc_k(st, kk), desc_v(st + (1 + h) * SLAB, 0, kk));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int h = 0; h < NH; ++h) fence_regs(acc[h]);
  }
  cp_async_wait<0>();

  // ---- epilogue: dq = scale (acc + dqn inter n_c) ------------------------------------------
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = r_lo + 8 * x, j = row0 + r, p = p0 + j;
    if (j >= L || p >= S) continue;
    const float dqi = sDi[r];
    bf16* out = dq + head + (size_t)p * rs + d0;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = h * TILE + 8 * jj + 2 * tq;
        const int i = 4 * jj + 2 * x;
        *reinterpret_cast<uint32_t*>(out + col) =
            pack_bf16(scale * fmaf(dqi, sNq[col], acc[h][i]),
                      scale * fmaf(dqi, sNq[col + 1], acc[h][i + 1]));
      }
  }
}

// ---- phase 4: dk, dv from the kept tiles ------------------------------------------
// one block per (64 NH columns, B·H, chunk, key tile), key tile 0 first: per
// query tile from the diagonal on, dk += ds'ᵀ·q and dv += (w / denom)ᵀ·dh
// (A: the kept tiles read MN-major, i.e. transposed; B: q, dh MN-major);
// then the state terms from phase 0: dk = scale dk + sc (dCv + dnE_c), dv +=
// (k ⊙ sc)·dCE_c
template <int NH>
__global__ void __launch_bounds__(NT)
mlstm_bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ dh,
         const bf16* __restrict__ pt, const float* __restrict__ gates,
         const float* __restrict__ mS, const float* __restrict__ dCv,
         const float* __restrict__ dvs, const float* __restrict__ dnE,
         bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int hd, int L, int nc,
         int Sp, int ntile, float scale) {
  constexpr int STG = (2 + 2 * NH) * SLAB;  // a stage (of 2): ds', w / denom, NH slabs of q, dh
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_addr(smem_raw));
  float* sSc = reinterpret_cast<float*>(gbase + 2 * STG);  // [64] the keys' update weights
  float* sDn = sSc + TILE;                                  // [64 NH] dnE_c of the columns

  const int ncb = hd / (TILE * NH);
  int idx = blockIdx.x;
  const int ct = idx % ncb;
  idx /= ncb;
  const int BH = gridDim.x / (ncb * nc * ntile);
  const int bh = idx % BH;
  idx /= BH;
  const int c = idx % nc, it = idx / nc;
  const int b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int p0 = c * L, key0 = it * TILE, c0 = ct * TILE * NH;
  const size_t rs = (size_t)H * hd;
  const size_t head = (size_t)b * S * rs + (size_t)hh * hd;
  const float* gF = gates + (size_t)bh * 3 * Sp + p0;
  const float m_c = mS[(size_t)bh * nc + c];
  const int ntri = ntile * (ntile + 1) / 2;
  const bf16* tds = pt + ((size_t)bh * nc + c) * ntri * PT;
  const bf16* twd = tds + (size_t)BH * nc * ntri * PT;
  const float FL = gF[L - 1];
  const float m_next = fmaxf(FL + m_c, gF[Sp + L - 1]);
  if (tid < TILE) {
    const int m = key0 + tid;
    sSc[tid] = m < L ? expf(((FL - gF[m]) + gF[2 * Sp + m]) - m_next) : 0.f;
  }
  for (int x = tid; x < TILE * NH; x += NT) sDn[x] = dnE[((size_t)bh * nc + c) * hd + c0 + x];
  const int U = ntile - it;
  auto issue = [&](int t) {  // query tile it + t
    if (t < U) {
      const int jq = it + t;
      const uint32_t st = base + (t & 1) * STG;
      copy_tile(st, tds + (size_t)tri(jq, it) * PT, tid);
      copy_tile(st + SLAB, twd + (size_t)tri(jq, it) * PT, tid);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        load_tile(st + (2 + h) * SLAB, q + head, rs, p0, jq * TILE, S, c0 + h * TILE, tid);
        load_tile(st + (2 + NH + h) * SLAB, dh + head, rs, p0, jq * TILE, S, c0 + h * TILE, tid);
      }
    }
    cp_async_commit();
  };
  issue(0);

  const int r_lo = warp * 16 + g;
  float dka[NH][32], dva[NH][32];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[h][i] = dva[h][i] = 0.f;
  for (int t = 0; t < U; ++t) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    issue(t + 1);
    const uint32_t st = base + (t & 1) * STG;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        wgmma_ss_n64_t<1, 1>(dka[h], desc_v(st, 0, kk), desc_v(st + (2 + h) * SLAB, 0, kk));
        wgmma_ss_n64_t<1, 1>(dva[h], desc_v(st + SLAB, 0, kk),
                             desc_v(st + (2 + NH + h) * SLAB, 0, kk));
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      fence_regs(dka[h]);
      fence_regs(dva[h]);
    }
  }
  cp_async_wait<0>();

  // ---- epilogue: the state terms from phase 0; dk = scale dka + sc (dCv + dnE) -------
  const float* cvr = dCv + ((size_t)bh * Sp + p0) * hd + c0;
  const float* svr = dvs + ((size_t)bh * Sp + p0) * hd + c0;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = r_lo + 8 * x, m = key0 + r, p = p0 + m;
    if (m >= L || p >= S) continue;
    const float sc = sSc[r];
    bf16* ok = dk + head + (size_t)p * rs + c0;
    bf16* ov = dv + head + (size_t)p * rs + c0;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      float2 cv[8], sv[8];  // a row's 16 columns of the block half, loaded together
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = h * TILE + 8 * jj + 2 * tq;
        cv[jj] = *reinterpret_cast<const float2*>(cvr + (size_t)m * hd + col);
        sv[jj] = *reinterpret_cast<const float2*>(svr + (size_t)m * hd + col);
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = h * TILE + 8 * jj + 2 * tq, i = 4 * jj + 2 * x;
        *reinterpret_cast<uint32_t*>(ok + col) =
            pack_bf16(fmaf(sc, cv[jj].x + sDn[col], scale * dka[h][i]),
                      fmaf(sc, cv[jj].y + sDn[col + 1], scale * dka[h][i + 1]));
        *reinterpret_cast<uint32_t*>(ov + col) =
            pack_bf16(dva[h][i] + sv[jj].x, dva[h][i + 1] + sv[jj].y);
      }
    }
  }
}

template <typename K>
cudaError_t set_smem(K kern, int smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// phase 2a at NE 64-column blocks of e a block
template <int NE>
cudaError_t launch_carry_gc(const bf16* q, const bf16* dh, const float* gates, const float* mS,
                            const float* rows, float* dCE, float* dnE, int BH, int S, int H,
                            int hd, int L, int nc, int Sp, float scale, cudaStream_t st) {
  const int smem = 1024 + 2 * (1 + NE) * TILE * 128 + RAW_STAGES * (1 + NE) * KI * 128 +
                   (int)sizeof(float) * 2 * MAX_L;
  cudaError_t e;
  if ((e = set_smem(mlstm_bwd_carry_gc<NE>, smem)) != cudaSuccess) return e;
  mlstm_bwd_carry_gc<NE><<<dim3(hd / (TILE * NE), hd / TILE, (nc - 1) * BH), NT, smem, st>>>(
      q, dh, gates, mS, rows, dCE, dnE, S, H, hd, L, nc, Sp, scale);
  return cudaGetLastError();
}

// phase 3 at NH 64-column blocks a block
template <int NH>
cudaError_t launch_dq(const bf16* k, const bf16* pt, const float* gates, const float* X,
                      const float* nS, const float* mS, const float* rows, bf16* dq, int BH,
                      int S, int H, int hd, int L, int nc, int Sp, int ntile, float scale,
                      cudaStream_t st) {
  const int smem = 1024 + 2 * (1 + NH) * SLAB + (int)sizeof(float) * (2 + NH) * TILE;
  cudaError_t e;
  if ((e = set_smem(mlstm_bwd_dq<NH>, smem)) != cudaSuccess) return e;
  mlstm_bwd_dq<NH><<<hd / (TILE * NH) * ntile * nc * BH, NT, smem, st>>>(
      k, pt, gates, X, nS, mS, rows, dq, S, H, hd, L, nc, Sp, ntile, scale);
  return cudaGetLastError();
}

// phase 4 at NH 64-column blocks a block
template <int NH>
cudaError_t launch_dkdv(const bf16* q, const bf16* dh, const bf16* pt, const float* gates,
                        const float* mS, const float* dCv, const float* dvs, const float* dnE,
                        bf16* dk, bf16* dv, int BH, int S, int H, int hd, int L, int nc, int Sp,
                        int ntile, float scale, cudaStream_t st) {
  const int smem = 1024 + 2 * (2 + 2 * NH) * SLAB + (int)sizeof(float) * (1 + NH) * TILE;
  cudaError_t e;
  if ((e = set_smem(mlstm_bwd_dkdv<NH>, smem)) != cudaSuccess) return e;
  mlstm_bwd_dkdv<NH><<<hd / (TILE * NH) * ntile * nc * BH, NT, smem, st>>>(
      q, dh, pt, gates, mS, dCv, dvs, dnE, dk, dv, S, H, hd, L, nc, Sp, ntile, scale);
  return cudaGetLastError();
}

}  // namespace

namespace repro {

// Phases 0-4 of the bf16 backward (mlstm_chunk_bwd.cu runs the gate phase
// after them). q, k, v, dh, dq, dk, dv [B, S, H, hd] bf16; the forward's
// saved float32 gates [B·H, 3, Sp], CT [B·H, nc, hd, hd] (C_cᵀ in TF32), nS
// [B·H, nc, hd], mS [B·H, nc]; dCout / dnout (the state out's gradient) and
// Cend / nend (the state out) float32 or null; float32 scratch rows
// [B·H, 6, Sp], dlsc [B·H, hd / 64, Sp], dCE [B·H, nc, hd, hd], dnE [B·H, nc,
// hd], ddp [B·H, nc, (hd / 32)^2 + 1], dmp [B·H, (hd / 32)^2 + 1], xs [2, B·H,
// Sp, hd] (phase 0's products: X, then dCv; (k ⊙ sc)·dCE), xq [B·H, 2, hd /
// 64, Sp], cols [B·H, ntile, Sp], sp [B·H, nc, ntile (ntile + 1) / 2, 2, 64
// x 64] (phase 1's S and P); bf16 scratch pt [2, B·H, nc, ntile (ntile + 1)
// / 2, 64 x 64] (the kept pair tiles). hd a multiple of 64 up to 512, 1 <= L
// <= 512.
int mlstm_chunk_bwd_wgmma(const void* q, const void* k, const void* v, const void* dh,
                          const float* gates, const float* CT, const float* nS,
                          const float* mS, const float* dCout, const float* dnout,
                          const float* Cend, const float* nend, void* dq, void* dk, void* dv,
                          float* rows, float* dlsc, float* dCE, float* dnE, float* ddp,
                          float* dmp, float* xs, float* xq, float* cols, void* pt, float* sp,
                          int B, int S, int H, int hd, int L, float scale, int has_state,
                          cudaStream_t st) {
  if (hd % TILE != 0 || hd > 512 || L < 1 || L > MAX_L) return (int)cudaErrorInvalidValue;
  const int BH = B * H, nc = (S + L - 1) / L, Sp = nc * L, ntile = (L + TILE - 1) / TILE;
  const int ncol = hd / TILE;
  auto Q = static_cast<const bf16*>(q);
  auto K_ = static_cast<const bf16*>(k);
  auto V = static_cast<const bf16*>(v);
  auto DH = static_cast<const bf16*>(dh);
  auto PTS = static_cast<bf16*>(pt);
  float* X = xs;                             // X, then dCv
  float* DVS = xs + (size_t)BH * Sp * hd;    // (k ⊙ sc)·dCE
  cudaError_t e;

  const int smem0 = 1024 + (hd / 32) * SLAB + SLAB_WGS * SLAB_WG + (int)sizeof(float) * TILE;
  if ((e = set_smem(mlstm_bwd_slab_x, smem0)) != cudaSuccess ||
      (e = set_smem(mlstm_bwd_slab_state, smem0)) != cudaSuccess)
    return (int)e;
  mlstm_bwd_slab_x<<<dim3(ncol, nc, BH), SLAB_NT, smem0, st>>>(DH, Q, CT, nS, gates, mS, X, xq, S,
                                                              H, hd, L, nc, Sp, ntile, has_state);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const int smem1 = 1024 + (2 * (hd / TILE) + 8) * SLAB +
                    (int)sizeof(float) * (2 * ntile * TILE + 18 * TILE);
  if ((e = set_smem(mlstm_bwd_pairs, smem1)) != cudaSuccess) return (int)e;
  mlstm_bwd_pairs<<<ntile * nc * BH, PAIR_NT, smem1, st>>>(Q, K_, V, DH, gates, xq, mS, rows, cols,
                                                            PTS, sp, S, H, hd, L, nc, Sp, ntile,
                                                            scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const bool wide = hd % (2 * TILE) == 0;  // 128 columns a block where they divide hd
  if (nc > 1) {
    e = wide ? launch_carry_gc<2>(Q, DH, gates, mS, rows, dCE, dnE, BH, S, H, hd, L, nc, Sp,
                                  scale, st)
             : launch_carry_gc<1>(Q, DH, gates, mS, rows, dCE, dnE, BH, S, H, hd, L, nc, Sp,
                                  scale, st);
    if (e != cudaSuccess) return (int)e;
  }
  const int NP = (hd / RT) * (hd / RT) + 1;
  mlstm_bwd_carry_rec<<<dim3(NP, BH), REC_NT, 0, st>>>(gates, CT, nS, mS, dCout, dnout, Cend,
                                                       nend, dCE, dnE, ddp, dmp, hd, L, nc, Sp,
                                                       has_state);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  auto DQ = static_cast<bf16*>(dq);
  e = wide ? launch_dq<2>(K_, PTS, gates, X, nS, mS, rows, DQ, BH, S, H, hd, L, nc, Sp, ntile,
                          scale, st)
           : launch_dq<1>(K_, PTS, gates, X, nS, mS, rows, DQ, BH, S, H, hd, L, nc, Sp, ntile,
                          scale, st);
  if (e != cudaSuccess) return (int)e;

  // dq has read X: the buffer takes dCv
  mlstm_bwd_slab_state<<<dim3(ncol, nc, 2 * BH), SLAB_NT, smem0, st>>>(
      V, K_, dCE, dnE, gates, mS, X, dlsc, DVS, S, H, hd, L, nc, Sp, ntile);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  auto DK = static_cast<bf16*>(dk);
  auto DV = static_cast<bf16*>(dv);
  e = wide ? launch_dkdv<2>(Q, DH, PTS, gates, mS, X, DVS, dnE, DK, DV, BH, S, H, hd, L, nc, Sp,
                            ntile, scale, st)
           : launch_dkdv<1>(Q, DH, PTS, gates, mS, X, DVS, dnE, DK, DV, BH, S, H, hd, L, nc, Sp,
                            ntile, scale, st);
  return (int)e;
}

}  // namespace repro
