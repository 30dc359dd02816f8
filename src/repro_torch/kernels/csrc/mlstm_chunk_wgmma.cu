// Chunkwise mLSTM for Hopper (sm_90a) in bf16: the chunkwise-parallel form on
// the tensor cores (wgmma), in three phases.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm_chunk.py::
// mlstm_chunk for bf16 inputs (the served xlstm-350m runs bf16; the float32
// parity path keeps the CUDA-core kernel of mlstm_chunk.cu, chosen by dtype
// at the C entry point mlstm_chunk_fwd). Same contract and math as that
// kernel and as the plain version (kernels/mlstm_chunk.py): per chunk of L
// rows, F = cumsum(log_sigmoid(fg)), m_j = max(F_j + m, max_{i<=j}
// (F_j - F_i) + ig_i), h_j = (inter_j (q_j·C) + Σ_{i<=j} w_ji v_i) /
// max(|inter_j (q_j·n) + Σ_i w_ji|, exp(-m_j)) with w_ji = (q_j·k_i)
// exp((F_j - F_i) + ig_i - m_j), and the float32 (C, n, m) state carried
// over chunks; rows past S pad the last chunk with ig = -1e30, fg = 30.
//
// What bounds it on an H100: operations on the tensor cores. At xlstm-350m's
// prefill (S = 2048, H = 4, hd = 512, L = 256) the causal q·kᵀ and w·v
// products are ~4.3 GFLOP in bf16 and q·C and the state updates ~6.4 GFLOP
// in TF32, on ~25 MB of q/k/v/h and state. The recurrence over chunks is
// only in C, so (Beck et al., "Tiled Flash Linear Attention", 2025, and the
// chunkwise kernels of the public xLSTM mlstm_kernels) the work splits into
// a short serial part and a wide parallel one:
//
//   1. gates, grid (chunks, B·H): F and the intra-chunk stabiliser
//      m_intra_j = max_{i<=j} (F_j - F_i) + ig_i of every row, in the plain
//      version's order of operations (F grows large and negative over a long
//      prompt, so (F_j - F_i) + ig_i and F_j + (ig_i - F_i) round apart),
//      into a float32 scratch [B·H, 3, nc·L] (F, m_intra, ig padded).
//   2. chunk states, grid (hd/64 value columns, hd/64 key columns, B·H):
//      each block owns a 64 x 64 tile of C in registers and walks the chunks:
//      the scalar recurrence m_{c+1} = max(F_L + m_c, m_intra_L), then
//      C_{c+1} = decay_c C_c + (k ⊙ sc)ᵀ v as TF32 wgmma with float32
//      accumulation (k ⊙ sc is float32 and must not round to bf16: the state
//      is carried over up to 16 chunks). TF32 operands are K-major only (no
//      transpose bit), so k ⊙ sc and v are stored transposed, [column][row],
//      into shared memory. It writes C_c (transposed and rounded to TF32:
//      phase 3's operand), n_c and m_c at every chunk start to scratch, and
//      the last chunk's (C, n, m) as the state out.
//   3. outputs, one block per (64-row tile, chunk, B·H, value tile of BV
//      columns), longest causal tiles first, all chunks at once: h_inter =
//      q·C_c as TF32 wgmma (q widened to float32 in shared memory, C_c
//      streamed from scratch), scaled by inter_j; then per key tile up to the
//      diagonal S = q·kᵀ as bf16 wgmma, w = S ⊙ D in registers (float32 row
//      sums for the denominator), and h += w·v as bf16 wgmma with w in
//      registers, split into its bf16 rounding and the bf16 remainder (two
//      products): one bf16 rounding of w, as the JAX XLA path's
//      w.astype(v.dtype), moves h by ~2e-2 at |h| ~ 9 and hd = 512, which
//      with h's own bf16 rounding (half an ulp: 0.03 at |h| >= 8) reaches
//      the bf16 bound of 5e-2; the split keeps w to ~16 bits (~2e-3).
//      q·n_j needs no hd-wide n_j: q·n_j = inter_j (q·n_c) + Σ_i w_ji.
//
// Operand tiles are 128-byte rows in the 128-byte swizzle, loaded with
// cp.async (16 bytes a thread, zero fill past S) through a ring, so the next
// slab's load overlaps this slab's products.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;

constexpr int NT = 128;         // phases 2 and 3: one warpgroup
constexpr int GATE_NT = 256;    // phase 1
constexpr int MAX_L = 512;      // the largest chunk
constexpr int TILE = 64;        // query rows / keys of a tile; C tile edge
constexpr int KI = 32;          // phase 2: chunk rows per TF32 k slab (128 bytes)
constexpr int MAX_BV = 128;     // phase 3: value columns a block
constexpr int SLAB = TILE * 128;     // one 64-row, 128-byte swizzled slab
constexpr int RING = 3 * 2 * SLAB;   // phase 3 ring: 3 stages of a q and a k slab
constexpr int P3_STAGE = SLAB + MAX_BV * 128 + TILE * 64;  // phase 3: a TF32 stage
constexpr int P3_REGION = 2 * P3_STAGE > RING ? 2 * P3_STAGE : RING;
constexpr int P2_PAIR = 2 * TILE * 128;  // phase 2: a TF32 slab pair, k ⊙ sc and v
constexpr int P2_RAW = 2 * KI * 128;     // phase 2: raw bf16 k and v rows of a step
constexpr int RAW_STAGES = 4;            // phase 2: raw steps in the ring

__device__ __forceinline__ float log_sigmoid(float x) {
  // jax.nn.log_sigmoid(x) = -softplus(-x)
  return -(fmaxf(-x, 0.f) + log1pf(expf(-fabsf(x))));
}

// ---- phase 1: gates ----------------------------------------------------------
__global__ void __launch_bounds__(GATE_NT)
mlstm_gates(const float* __restrict__ ig, const float* __restrict__ fg,
            float* __restrict__ gates, int S, int H, int L, int Sp) {
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __shared__ float sF[MAX_L], sIg[MAX_L];
  const int p0 = c * L;
  for (int j = tid; j < L; j += GATE_NT) {
    const int p = p0 + j;
    const bool real = p < S;
    const size_t at = ((size_t)b * S + p) * H + hh;
    sF[j] = log_sigmoid(real ? fg[at] : 30.f);
    sIg[j] = real ? ig[at] : kNegInf;
  }
  __syncthreads();
  if (warp == 0) {  // inclusive scan of sF[0:L) by one warp
    const int per = (L + 31) / 32, j0 = lane * per;
    float run = 0.f;
    for (int e = 0; e < per; ++e) {
      const int j = j0 + e;
      if (j < L) { run += sF[j]; sF[j] = run; }
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float nb = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += nb;
    }
    const float excl = incl - run;
    for (int e = 0; e < per; ++e) {
      const int j = j0 + e;
      if (j < L) sF[j] += excl;
    }
  }
  __syncthreads();
  float* g = gates + (size_t)bh * 3 * Sp + p0;
  for (int j = tid; j < L; j += GATE_NT) {
    const float Fj = sF[j];
    float mi = kNegInf;
    for (int i = 0; i <= j; ++i) mi = fmaxf(mi, (Fj - sF[i]) + sIg[i]);
    g[j] = Fj;
    g[Sp + j] = mi;
    g[2 * Sp + j] = sIg[j];
  }
}

// ---- phase 2: chunk states -----------------------------------------------------
// grid (hd / 64 value columns e, hd / 64 key columns d, B·H). The chunk rows
// stream through in steps of KI: raw bf16 k and v rows arrive by cp.async
// RAW_STAGES - 1 steps ahead (nothing of a load depends on the state), each
// step is transposed into a TF32 slab pair with the chunk's update weights,
// and its wgmma runs while the next step is transposed into the other pair.
__global__ void __launch_bounds__(NT)
mlstm_states(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
             const float* __restrict__ gates, const float* __restrict__ C0,
             const float* __restrict__ n0, const float* __restrict__ m0,
             float* __restrict__ CT, float* __restrict__ nS, float* __restrict__ mS,
             float* __restrict__ Cout, float* __restrict__ nout, float* __restrict__ mout,
             int S, int H, int hd, int L, int nc, int Sp) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_addr(smem_raw));
  // TF32 slab pairs [64 d][32 i] and [64 e][32 i] (two), then the raw ring
  const uint32_t raw = base + 2 * P2_PAIR;
  float* sSc = reinterpret_cast<float*>(gbase + 2 * P2_PAIR + RAW_STAGES * P2_RAW);
  float* sN = sSc + MAX_L;                                // [64] n of this d tile

  const int et = blockIdx.x, dt = blockIdx.y, bh = blockIdx.z, b = bh / H, hh = bh - b * H;
  const int e0 = et * TILE, d0 = dt * TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const float* gF = gates + (size_t)bh * 3 * Sp;
  const float* gM = gF + Sp;
  const float* gI = gF + 2 * Sp;
  const size_t rs = (size_t)H * hd;  // between positions
  const __nv_bfloat16* kb = k + (size_t)b * S * rs + (size_t)hh * hd + d0;
  const __nv_bfloat16* vb = v + (size_t)b * S * rs + (size_t)hh * hd + e0;

  // this thread's accumulator rows d and columns e (wgmma m64n64 layout)
  const int ra = warp * 16 + g;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int d = d0 + ra + 8 * ((i >> 1) & 1), e = e0 + 8 * (i >> 2) + 2 * tq + (i & 1);
    acc[i] = C0 != nullptr ? C0[((size_t)bh * hd + d) * hd + e] : 0.f;
  }
  if (tid < TILE) sN[tid] = n0 != nullptr ? n0[(size_t)bh * hd + d0 + tid] : 0.f;
  float m = m0 != nullptr ? m0[bh] : kNegInf;

  // raw step t: KI rows of k (64 columns d) and of v (64 columns e), 128-byte
  // rows in the swizzle, zero past the chunk and past S
  const int nsteps = (L + KI - 1) / KI, T = nc * nsteps;
  auto issue = [&](int t) {
    if (t < T) {
      const int c = t / nsteps, i0 = (t - c * nsteps) * KI;
      const uint32_t dk = raw + (t % RAW_STAGES) * P2_RAW, dv = dk + KI * 128;
      for (int e = tid; e < KI * 8; e += NT) {
        const int r = e >> 3, ch = e & 7, i = i0 + r, p = c * L + i;
        const bool ok = i < L && p < S;
        const size_t at = (size_t)(ok ? p : 0) * rs + ch * 8;
        cp_async16(dk + swz128(r, ch), kb + at, ok);
        cp_async16(dv + swz128(r, ch), vb + at, ok);
      }
    }
    cp_async_commit();  // empty past the end: the wait counts stay uniform
  };
  for (int t = 0; t < RAW_STAGES - 1; ++t) issue(t);

  for (int c = 0; c < nc; ++c) {
    const int p0 = c * L;
    // ---- the state at the chunk's start -------------------------------------------
    if (c > 0 || C0 != nullptr) {  // phase 3 reads no C_0 of a zero start
      float* ct = CT + ((size_t)bh * nc + c) * hd * hd;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int d = d0 + ra + 8 * ((i >> 1) & 1), e = e0 + 8 * (i >> 2) + 2 * tq + (i & 1);
        ct[(size_t)e * hd + d] = to_tf32(acc[i]);
      }
    }
    __syncthreads();  // sN and sSc of the previous chunk are settled
    if (et == 0 && tid < TILE) nS[((size_t)bh * nc + c) * hd + d0 + tid] = sN[tid];
    if (et == 0 && dt == 0 && tid == 0) mS[(size_t)bh * nc + c] = m;
    // ---- m recurrence, decay and the update weights ---------------------------------
    const float FL = gF[p0 + L - 1];
    const float m_next = fmaxf(FL + m, gM[p0 + L - 1]);
    const float decay = expf((FL + m) - m_next);
    for (int i = tid; i < nsteps * KI; i += NT)
      sSc[i] = i < L ? expf(((FL - gF[p0 + i]) + gI[p0 + i]) - m_next) : 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= decay;
    float np[2][8];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 8; ++e) np[u][e] = 0.f;
    for (int s = 0; s < nsteps; ++s) {
      const int t = c * nsteps + s;
      cp_async_wait<RAW_STAGES - 2>();  // raw step t has landed
      __syncthreads();  // ... for every thread; sSc is written; step t - 2's wgmma is done
      issue(t + RAW_STAGES - 1);        // into the slot step t - 1 was read from
      // k ⊙ sc and v, transposed: row = column d (or e), 128-byte row of 32 i
      const uint8_t* rk = gbase + (raw - base) + (t % RAW_STAGES) * P2_RAW;
      const uint8_t* rv = rk + KI * 128;
      uint8_t* A = gbase + (t & 1) * P2_PAIR;
      uint8_t* Bm = A + P2_PAIR / 2;
      const float sc = sSc[s * KI + lane];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int cv = warp + 4 * u;  // 8-column vector of this row
        const uint4 kr = *reinterpret_cast<const uint4*>(rk + swz128(lane, cv));
        const uint4 vr = *reinterpret_cast<const uint4*>(rv + swz128(lane, cv));
        const __nv_bfloat16* kh = reinterpret_cast<const __nv_bfloat16*>(&kr);
        const __nv_bfloat16* vh = reinterpret_cast<const __nv_bfloat16*>(&vr);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int r = cv * 8 + e;
          const uint32_t off = swz128(r, lane >> 2) + (lane & 3) * 4;
          const float kv = __bfloat162float(kh[e]) * sc;
          np[u][e] += kv;
          *reinterpret_cast<float*>(A + off) = to_tf32(kv);
          *reinterpret_cast<float*>(Bm + off) = __bfloat162float(vh[e]);
        }
      }
      fence_async_smem();
      __syncthreads();
      const uint32_t sA = base + (t & 1) * P2_PAIR, sB = sA + P2_PAIR / 2;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_tf32_n64(acc, desc_k(sA, kk), desc_k(sB, kk), 1);
      wgmma_commit();
      wgmma_wait<1>();  // step t - 1's products are done: its slab pair is free
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // n_{c+1} = decay n_c + Σ_i sc_i k_i over this d tile (float32, unrounded)
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
    m = m_next;
  }
  cp_async_wait<0>();
  // ---- state out ------------------------------------------------------------------
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int d = d0 + ra + 8 * ((i >> 1) & 1), e = e0 + 8 * (i >> 2) + 2 * tq;
    *reinterpret_cast<float2*>(Cout + ((size_t)bh * hd + d) * hd + e) =
        make_float2(acc[i], acc[i + 1]);
  }
  __syncthreads();
  if (et == 0 && tid < TILE) nout[(size_t)bh * hd + d0 + tid] = sN[tid];
  if (et == 0 && dt == 0 && tid == 0) mout[bh] = m;
}

// ---- phase 3: outputs ------------------------------------------------------------
// one block per (value tile, B·H, chunk, 64-row tile), longest tiles first
template <int BV>
__global__ void __launch_bounds__(NT, 2)
mlstm_outputs(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const float* __restrict__ gates,
              const float* __restrict__ CT, const float* __restrict__ nS,
              const float* __restrict__ mS, __nv_bfloat16* __restrict__ h, int S, int H,
              int hd, int L, int nc, int Sp, int ntile, float scale, int has_state) {
  constexpr int NCB = BV / TILE;  // 64-column blocks of the value tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t ring = base;                // phase a: TF32 stages; phase b: q / k ring
  const uint32_t vbuf = base + P3_REGION;    // 2 x [64 keys x BV] bf16
  float* sF = reinterpret_cast<float*>(gbase + P3_REGION + 2 * BV * 128);  // [ntile * 64]
  float* sIg = sF + ntile * TILE;
  float* sMj = sIg + ntile * TILE;           // [64] per query row
  float* sInter = sMj + TILE;
  float* sEmj = sInter + TILE;
  float* sQn = sEmj + TILE;
  float* sN = sQn + TILE;                    // [hd]

  int idx = blockIdx.x;
  const int nv = hd / BV;
  const int vt = idx % nv;
  idx /= nv;
  const int BH = gridDim.x / (nv * nc * ntile);
  const int bh = idx % BH;
  idx /= BH;
  const int c = idx % nc, jt = ntile - 1 - idx / nc;
  const int b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int p0 = c * L, row0 = jt * TILE;   // chunk start; first query row in the chunk
  const size_t rs = (size_t)H * hd;
  const size_t head = (size_t)b * S * rs + (size_t)hh * hd;
  const __nv_bfloat16* qb = q + head;
  const __nv_bfloat16* kb = k + head;
  const __nv_bfloat16* vb = v + head + vt * BV;
  const float* gF = gates + (size_t)bh * 3 * Sp + p0;

  // ---- gates of this chunk's keys and of this tile's rows --------------------------
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
  }
  const float* n_c = nS + ((size_t)bh * nc + c) * hd;
  for (int d = tid; d < hd; d += NT) sN[d] = n_c[d];
  __syncthreads();

  float acc[NCB][32];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
  const int r_lo = warp * 16 + g;  // this thread's accumulator rows r_lo, r_lo + 8

  // ---- a. h_inter = q·C_c (TF32), scaled by inter_j · scale ---------------------------
  if (has_state || c > 0) {
    const float* ctile = CT + (((size_t)bh * nc + c) * hd + vt * BV) * hd;  // [BV e][hd d]
    // stage st: [q widened, 64 x 32 float32][C_cᵀ, BV x 32][q, 64 x 32 bf16]
    auto stage = [&](int st) { return ring + st * P3_STAGE; };
    auto c_slab = [&](int t, int st) {  // columns d in [32 t, 32 t + 32)
      const uint32_t dc = stage(st) + SLAB, dq = dc + BV * 128;
      for (int e = tid; e < BV * 8; e += NT) {
        const int r = e >> 3, ch = e & 7;
        cp_async16(dc + swz128(r, ch), ctile + (size_t)r * hd + t * 32 + ch * 4, true);
      }
      for (int e = tid; e < TILE * 4; e += NT) {
        const int r = e >> 2, ch = e & 3, j = row0 + r, p = p0 + j;
        const bool ok = j < L && p < S;
        cp_async16(dq + r * 64 + ch * 16, qb + (size_t)(ok ? p : 0) * rs + t * 32 + ch * 8, ok);
      }
      cp_async_commit();
    };
    const int T = hd / 32;
    float qn = 0.f;
    c_slab(0, 0);
    for (int t = 0; t < T; ++t) {
      const int st = t & 1;
      if (t + 1 < T) {
        c_slab(t + 1, st ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      // q widened to float32: row tid / 2, 16 columns a thread, and its q·n
      {
        const int r = tid >> 1, half = tid & 1;
        const uint8_t* qraw = gbase + (stage(st) - base) + SLAB + BV * 128 + r * 64 + half * 32;
        uint8_t* q32 = gbase + (stage(st) - base);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const uint4 raw = *reinterpret_cast<const uint4*>(qraw + 16 * x);
          const __nv_bfloat16* qh = reinterpret_cast<const __nv_bfloat16*>(&raw);
          float f[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            f[e] = __bfloat162float(qh[e]);
            qn = fmaf(f[e], sN[t * 32 + half * 16 + x * 8 + e], qn);
          }
          const int cq = half * 4 + x * 2;
          *reinterpret_cast<float4*>(q32 + swz128(r, cq)) = make_float4(f[0], f[1], f[2], f[3]);
          *reinterpret_cast<float4*>(q32 + swz128(r, cq + 1)) = make_float4(f[4], f[5], f[6], f[7]);
        }
      }
      fence_async_smem();
      __syncthreads();
      wgmma_fence();
      const uint32_t sq = stage(st), sc = sq + SLAB;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb)
          wgmma_tf32_n64(acc[cb], desc_k(sq, kk), desc_k(sc + cb * SLAB, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) fence_regs(acc[cb]);
      __syncthreads();  // stage st is consumed
    }
    qn += __shfl_xor_sync(0xffffffffu, qn, 1);  // the 2 threads of a row are adjacent
    if ((tid & 1) == 0) sQn[tid >> 1] = qn * scale;
    const float f0 = sInter[r_lo] * scale, f1 = sInter[r_lo + 8] * scale;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[cb][i] *= (i & 2) ? f1 : f0;
  } else if (tid < TILE) {
    sQn[tid] = 0.f;
  }
  __syncthreads();

  // ---- b. h_intra: per key tile, S = q·kᵀ (bf16), w = S ⊙ D, h += w·v ---------------
  const int NS = hd / TILE;                 // 64-column slabs of q and k
  const int U = (jt + 1) * NS;              // slabs over the key tiles up to the diagonal
  const int stages = NS >= 2 ? 3 : 2;       // a value tile is reloaded two key tiles on
  auto issue = [&](int t) {
    if (t < U) {
      const int it = t / NS, s = t - it * NS, st = t % stages;
      const uint32_t sq = ring + st * 2 * SLAB, sk = sq + SLAB;
      for (int e = tid; e < TILE * 8; e += NT) {
        const int r = e >> 3, ch = e & 7;
        const int jq = row0 + r, pq = p0 + jq;
        const int ik = it * TILE + r, pk = p0 + ik;
        cp_async16(sq + swz128(r, ch), qb + (size_t)min(pq, S - 1) * rs + s * TILE + ch * 8,
                   pq < S);
        cp_async16(sk + swz128(r, ch), kb + (size_t)min(pk, S - 1) * rs + s * TILE + ch * 8,
                   pk < S);
      }
      if (s == 0) {  // the value tile of key tile it, column blocks of 64
        const uint32_t dv = vbuf + (it & 1) * BV * 128;
        for (int e = tid; e < NCB * TILE * 8; e += NT) {
          const int cb = e / (TILE * 8), r = (e >> 3) & (TILE - 1), ch = e & 7;
          const int pk = p0 + it * TILE + r;
          cp_async16(dv + cb * SLAB + swz128(r, ch),
                     vb + (size_t)min(pk, S - 1) * rs + cb * TILE + ch * 8, pk < S);
        }
      }
    }
    cp_async_commit();  // empty past the end: the wait counts stay uniform
  };
  for (int t = 0; t < stages - 1; ++t) issue(t);
  float sacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
  float wsum[2] = {0.f, 0.f};
  for (int t = 0; t < U; ++t) {
    const int it = t / NS, s = t - it * NS, st = t % stages;
    if (stages == 3) cp_async_wait<1>();
    else cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    issue(t + stages - 1);
    const uint32_t sq = ring + st * 2 * SLAB, sk = sq + SLAB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(sacc, desc_k(sq, kk), desc_k(sk, kk), s > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);
    if (s != NS - 1) continue;
    // w_ji = S_ji · scale · exp((F_j - F_i) + ig_i - m_j) for i <= j < L
    uint32_t pa[4][4], pl[4][4];  // w in bf16, and its bf16 remainder
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int hi = (i >> 1) & 1, r = r_lo + 8 * hi, jl = row0 + r;
      float w[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int il = it * TILE + 8 * (i >> 2) + 2 * tq + x;
        w[x] = 0.f;
        if (il <= jl && jl < L)
          w[x] = sacc[i + x] * scale * expf(((sF[jl] - sF[il]) + sIg[il]) - sMj[r]);
        wsum[hi] += w[x];
      }
      const uint32_t wb = pack_bf16(w[0], w[1]);
      const float2 hf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wb));
      pa[i >> 3][(i >> 1) & 3] = wb;
      pl[i >> 3][(i >> 1) & 3] = pack_bf16(w[0] - hf.x, w[1] - hf.y);
    }
    const uint32_t sv = vbuf + (it & 1) * BV * 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        wgmma_rs_n64(acc[cb], pa[kk], desc_v(sv, cb, kk));
        wgmma_rs_n64(acc[cb], pl[kk], desc_v(sv, cb, kk));
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) fence_regs(acc[cb]);
  }
  cp_async_wait<0>();

  // ---- epilogue: h = acc / max(|inter_j (q·n) + Σ w|, exp(-m_j)) -----------------------
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    wsum[x] += __shfl_xor_sync(0xffffffffu, wsum[x], 1);
    wsum[x] += __shfl_xor_sync(0xffffffffu, wsum[x], 2);
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = r_lo + 8 * x, j = row0 + r, p = p0 + j;
    if (j >= L || p >= S) continue;
    const float inv = 1.f / fmaxf(fabsf(sInter[r] * sQn[r] + wsum[x]), sEmj[r]);
    __nv_bfloat16* hr = h + head + (size_t)p * rs + vt * BV;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = cb * TILE + 8 * jj + 2 * tq;
        *reinterpret_cast<uint32_t*>(hr + col) =
            pack_bf16(acc[cb][4 * jj + 2 * x] * inv, acc[cb][4 * jj + 2 * x + 1] * inv);
      }
  }
}

template <int BV>
int launch_outputs(const void* q, const void* k, const void* v, const float* gates,
                   const float* CT, const float* nS, const float* mS, void* h, int BH, int S,
                   int H, int hd, int L, int nc, int Sp, float scale, int has_state,
                   cudaStream_t st) {
  const int ntile = (L + TILE - 1) / TILE;
  const int smem = 1024 + P3_REGION + 2 * BV * 128 +
                   (int)sizeof(float) * (2 * ntile * TILE + 4 * TILE + hd);
  auto kern = mlstm_outputs<BV>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(hd / BV) * BH * nc * ntile, NT, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), gates, CT, nS, mS,
      static_cast<__nv_bfloat16*>(h), S, H, hd, L, nc, Sp, ntile, scale, has_state);
  return (int)cudaGetLastError();
}

}  // namespace

namespace repro {

// The bf16 route of mlstm_chunk_fwd (mlstm_chunk.cu). q, k, v, h
// [B, S, H, hd] bf16; ig, fg [B, S, H] float32; state in (C0 [B, H, hd, hd],
// n0 [B, H, hd], m0 [B, H]; all null for a zero start) and out (C, n, m)
// float32; scratch the wrapper allocates: gates [B·H, 3, nc·L], CT
// [B·H, nc, hd, hd], nS [B·H, nc, hd], mS [B·H, nc] float32. hd a multiple
// of 64 up to 512, 1 <= L <= 512, all contiguous and 16-byte aligned.
int mlstm_chunk_wgmma(const void* q, const void* k, const void* v, const float* ig,
                      const float* fg, const float* C0, const float* n0, const float* m0,
                      void* h, float* C, float* n, float* m, float* gates, float* CT,
                      float* nS, float* mS, int B, int S, int H, int hd, int L, float scale,
                      cudaStream_t st) {
  if (hd % TILE != 0 || hd > 512 || L < 1 || L > MAX_L) return (int)cudaErrorInvalidValue;
  const int BH = B * H, nc = (S + L - 1) / L, Sp = nc * L;
  mlstm_gates<<<dim3(nc, BH), GATE_NT, 0, st>>>(ig, fg, gates, S, H, L, Sp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const int smem2 =
      1024 + 2 * P2_PAIR + RAW_STAGES * P2_RAW + (int)sizeof(float) * (MAX_L + TILE);
  e = cudaFuncSetAttribute(mlstm_states, cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (e != cudaSuccess) return (int)e;
  mlstm_states<<<dim3(hd / TILE, hd / TILE, BH), NT, smem2, st>>>(
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), gates, C0,
      n0, m0, CT, nS, mS, C, n, m, S, H, hd, L, nc, Sp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const int has_state = C0 != nullptr;
  if (hd % MAX_BV == 0)
    return launch_outputs<MAX_BV>(q, k, v, gates, CT, nS, mS, h, BH, S, H, hd, L, nc, Sp,
                                  scale, has_state, st);
  return launch_outputs<TILE>(q, k, v, gates, CT, nS, mS, h, BH, S, H, hd, L, nc, Sp, scale,
                              has_state, st);
}

}  // namespace repro
