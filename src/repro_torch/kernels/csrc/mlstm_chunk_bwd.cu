// Chunkwise mLSTM backward for Hopper (sm_90a): the C entry point, the gate
// phase both routes share, and the float32 route on the CUDA cores.
//
// Replaces the gradient of the Pallas TPU kernel src/repro/kernels/
// mlstm_chunk.py::mlstm_chunk (the reference trains on XLA's autodiff of
// src/repro/models/xlstm.py::mlstm_chunkwise). Same contract as the plain
// version kernels/mlstm_chunk.py::mlstm_chunk_bwd, whose docstring derives
// the math; mlstm_chunk_bwd_wgmma.cu's note has it per chunk.
//
// Two routes, chosen by dtype in mlstm_chunk_bwd: bf16 (the card's train
// path) runs phases 0-4 of mlstm_chunk_bwd_wgmma.cu from the chunk states the
// bf16 forward saved; float32 (the parity path, held to 1e-4) runs the
// kernels below, with the plain version's float32 products and its gates
// (F, the stabilisers, every exponent) in float64 as the float32 forward
// runs them, from the chunk start states that forward saved (C_cᵀ, n_c and a
// float64 m_c: with_states). Both end with the gate phase:
//
//   gate phase, two launches of a block per (chunk, B·H): first each row's
//   residual (Σ dlogD + dinter·inter − R, R the exact row sum) to its
//   largest weight (its star column), dig and dF before the carry, and the
//   chunk's scalars (block sums in one order); then each block walks m_next's
//   reverse carry (G) from the last chunk to its own (a few operations a
//   chunk), adds it to the chunk's largest write or its last dF, and writes
//   dig and dfg = revcumsum(dF)·σ(−fg) by warp scans in one order. Every sum
//   has one order.
//
// The float32 kernels are simple on purpose (no tensor cores: TF32 cannot
// keep 1e-4): a warp per query row (row scalars; dq) or key row (dk, dv), its
// lanes over the head dim; the carry a thread per element of (dC, dn).
#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::warp_sum;

enum { kDenom = 0, kDqn = 1, kR = 2, kDi = 3, kRowsum = 4, kColsum = 5, NR = 6 };
constexpr int MAX_L = 512;
constexpr int GATE_NT = 256;
constexpr int WNT = 128;       // row kernels: four warps, a row each
constexpr int CARRY_NT = 256;
constexpr int MAX_U = 16;      // head-dim columns a lane (hd <= 512)

__device__ __forceinline__ double log_sigmoid(double x) {
  return -(fmax(-x, 0.0) + log1p(exp(-fabs(x))));
}
__device__ __forceinline__ float gexp(float x) { return expf(x); }
__device__ __forceinline__ double gexp(double x) { return exp(x); }

// ---- float32 route: the gates in float64 (the forward's phase 1) ---------------------
__global__ void __launch_bounds__(GATE_NT)
mlstm_bwd_gates_f64(const float* __restrict__ ig, const float* __restrict__ fg,
          double* __restrict__ gates, int S, int H, int L, int Sp) {
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __shared__ double sF[MAX_L], sIg[MAX_L];
  const int p0 = c * L;
  for (int j = tid; j < L; j += GATE_NT) {
    const int p = p0 + j;
    const bool real = p < S;
    const size_t at = ((size_t)b * S + p) * H + hh;
    sF[j] = log_sigmoid(real ? fg[at] : 30.0);
    sIg[j] = real ? ig[at] : kNegInf;
  }
  __syncthreads();
  if (warp == 0) {
    const int per = (L + 31) / 32, j0 = lane * per;
    double run = 0.0;
    for (int e = 0; e < per; ++e) {
      const int j = j0 + e;
      if (j < L) { run += sF[j]; sF[j] = run; }
    }
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double nb = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += nb;
    }
    const double excl = incl - run;
    for (int e = 0; e < per; ++e) {
      const int j = j0 + e;
      if (j < L) sF[j] += excl;
    }
  }
  __syncthreads();
  double* g = gates + (size_t)bh * 3 * Sp + p0;
  for (int j = tid; j < L; j += GATE_NT) {
    const double Fj = sF[j];
    double mi = kNegInf;
    for (int i = 0; i <= j; ++i) mi = fmax(mi, (Fj - sF[i]) + sIg[i]);
    g[j] = Fj;
    g[Sp + j] = mi;
    g[2 * Sp + j] = sIg[j];
  }
}

// a row of a [B, S, H, hd] float32 tensor, this lane's columns lane + 32 u
__device__ __forceinline__ void load_lane(float (&x)[MAX_U], const float* row, int nu, int lane,
                                          bool ok) {
#pragma unroll
  for (int u = 0; u < MAX_U; ++u) x[u] = (u < nu && ok) ? row[lane + 32 * u] : 0.f;
}
__device__ __forceinline__ float lane_dot(const float (&x)[MAX_U], const float* row, int nu,
                                          int lane) {
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < MAX_U; ++u)
    if (u < nu) s = fmaf(x[u], row[lane + 32 * u], s);
  return warp_sum(s);
}

// ---- float32 route: the row scalars, a warp per query row ------------------------------
__global__ void __launch_bounds__(WNT)
mlstm_bwd_rows_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dh,
                   const double* __restrict__ gates, const float* __restrict__ CT,
                   const float* __restrict__ nS, const double* __restrict__ mS,
                   float* __restrict__ rows, int S, int H, int hd, int L, int nc, int Sp,
                   float scale, int has_state) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * (WNT / 32) + warp, c = blockIdx.y, bh = blockIdx.z;
  if (j >= L) return;
  const int b = bh / H, hh = bh - b * H, nu = hd / 32, p0 = c * L, p = p0 + j;
  const size_t rs = (size_t)H * hd, head = (size_t)b * S * rs + (size_t)hh * hd;
  const double* gF = gates + (size_t)bh * 3 * Sp + p0;
  const double* gM = gF + Sp;
  const double* gI = gF + 2 * Sp;
  const double m_c = mS[(size_t)bh * nc + c];
  const double m_inter = gF[j] + m_c, mj = fmax(m_inter, gM[j]);
  const float inter = (float)exp(m_inter - mj), lo = (float)exp(-mj);
  const bool real = p < S;
  float qr[MAX_U], dr[MAX_U];
  load_lane(qr, q + head + (size_t)p * rs, nu, lane, real);
  load_lane(dr, dh + head + (size_t)p * rs, nu, lane, real);
  float qn_c = 0.f, hx = 0.f;
  if (has_state || c > 0) {
    const float* n_c = nS + ((size_t)bh * nc + c) * hd;
    const float* ct = CT + ((size_t)bh * nc + c) * hd * hd;  // [e][d]
    float qn = 0.f, hp = 0.f;
#pragma unroll
    for (int u = 0; u < MAX_U; ++u)
      if (u < nu) qn = fmaf(qr[u], n_c[lane + 32 * u], qn);
    for (int e = 0; e < hd; ++e) {  // dh·(q C): Σ_e dh_e Σ_d q_d C_de
      float t = 0.f;
#pragma unroll
      for (int u = 0; u < MAX_U; ++u)
        if (u < nu) t = fmaf(qr[u], ct[(size_t)e * hd + lane + 32 * u], t);
      hp = fmaf(real ? dh[head + (size_t)p * rs + e] : 0.f, t, hp);
    }
    qn_c = warp_sum(qn) * scale;
    hx = warp_sum(hp) * scale;
  }
  float A = 0.f, wp = 0.f;
  for (int m = 0; m <= j && p0 + m < S; ++m) {
    const size_t km = head + (size_t)(p0 + m) * rs;
    const float s = lane_dot(qr, k + km, nu, lane), P = lane_dot(dr, v + km, nu, lane);
    const float w = s * scale * (float)exp(((gF[j] - gF[m]) + gI[m]) - mj);
    A += w;
    wp = fmaf(w, P, wp);
  }
  if (lane == 0) {
    const float qn = inter * qn_c + A, aq = fabsf(qn);
    const float denom = fmaxf(aq, lo);
    const float dhh = inter * hx + wp;
    const float br = aq > lo ? 1.f : (aq == lo ? 0.5f : 0.f);
    const float sg = qn > 0.f ? 1.f : (qn < 0.f ? -1.f : 0.f);
    const float dqn = -dhh / (denom * denom) * br * sg;
    const float lb = aq < lo ? 1.f : (aq == lo ? 0.5f : 0.f);
    float* rw = rows + (size_t)bh * NR * Sp + p0 + j;
    rw[kDenom * Sp] = denom;
    rw[kDqn * Sp] = dqn;
    rw[kR * Sp] = lb * dhh / denom;
    rw[kDi * Sp] = (hx / denom + dqn * qn_c) * inter;
  }
}

// ---- float32 route: the reverse carry, a thread per element of (dC, dn) ----------------
__global__ void __launch_bounds__(CARRY_NT)
mlstm_bwd_carry_f32(const float* __restrict__ q, const float* __restrict__ dh,
          const double* __restrict__ gates, const float* __restrict__ CT,
          const float* __restrict__ nS, const double* __restrict__ mS,
          const float* __restrict__ rows, const float* __restrict__ dCout,
          const float* __restrict__ dnout, const float* __restrict__ Cend,
          const float* __restrict__ nend, float* __restrict__ dCE, float* __restrict__ dnE,
          float* __restrict__ ddp, float* __restrict__ dmp, int S, int H, int hd, int L,
          int nc, int Sp, float scale, int has_state) {
  __shared__ float sCoef[MAX_L], sW2[MAX_L], sRed[CARRY_NT / 32];
  const int bh = blockIdx.y, b = bh / H, hh = bh - b * H, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, NP = gridDim.x;
  const int id = blockIdx.x * CARRY_NT + tid, hd2 = hd * hd;
  const bool isC = id < hd2, isN = !isC && id < hd2 + hd;
  const int d = isC ? id / hd : id - hd2, e = isC ? id - d * hd : 0;
  const size_t rs = (size_t)H * hd, head = (size_t)b * S * rs + (size_t)hh * hd;
  const double* gF = gates + (size_t)bh * 3 * Sp;
  const double* gM = gF + Sp;
  const float* rw = rows + (size_t)bh * NR * Sp;
  auto block_sum = [&](float x) {
    x = warp_sum(x);
    __syncthreads();
    if (lane == 0) sRed[warp] = x;
    __syncthreads();
    float t = 0.f;
    for (int w = 0; w < CARRY_NT / 32; ++w) t += sRed[w];
    return t;
  };
  float val = 0.f, dm = 0.f;
  if (isC && dCout != nullptr) {
    val = dCout[(size_t)bh * hd2 + (size_t)d * hd + e];
    dm = val * Cend[(size_t)bh * hd2 + (size_t)d * hd + e];
  }
  if (isN && dnout != nullptr) {
    val = dnout[(size_t)bh * hd + d];
    dm = val * nend[(size_t)bh * hd + d];
  }
  dm = block_sum(dm);
  if (tid == 0) dmp[(size_t)bh * NP + blockIdx.x] = dm;
  for (int c = nc - 1; c >= 0; --c) {
    const int p0 = c * L;
    __syncthreads();  // the previous chunk's weights are consumed
    const double m_c = mS[(size_t)bh * nc + c];
    for (int i = tid; i < L; i += CARRY_NT) {
      const double m_inter = gF[p0 + i] + m_c;
      const float inter = (float)exp(m_inter - fmax(m_inter, gM[p0 + i]));
      sCoef[i] = scale * inter / rw[kDenom * Sp + p0 + i];
      sW2[i] = scale * rw[kDqn * Sp + p0 + i] * inter;
    }
    const double FL = gF[p0 + L - 1];
    const float decay = (float)exp((FL + m_c) - fmax(FL + m_c, gM[p0 + L - 1]));
    float dd = 0.f;
    if (isC) {
      dCE[((size_t)bh * nc + c) * hd2 + (size_t)d * hd + e] = val;
      if (has_state || c > 0) dd = val * CT[((size_t)bh * nc + c) * hd2 + (size_t)e * hd + d];
    } else if (isN) {
      dnE[((size_t)bh * nc + c) * hd + d] = val;
      dd = val * nS[((size_t)bh * nc + c) * hd + d];
    }
    dd = block_sum(dd);  // (its barriers also publish sCoef, sW2)
    if (tid == 0) ddp[((size_t)bh * nc + c) * NP + blockIdx.x] = dd;
    float gsum = 0.f;
    for (int i = 0; i < L && p0 + i < S; ++i) {
      const size_t at = head + (size_t)(p0 + i) * rs;
      if (isC) gsum = fmaf(q[at + d] * sCoef[i], dh[at + e], gsum);
      else if (isN) gsum = fmaf(q[at + d], sW2[i], gsum);
    }
    val = fmaf(val, decay, gsum);
  }
}

// ---- float32 route: dq, a warp per query row ---------------------------------------------
__global__ void __launch_bounds__(WNT)
mlstm_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dh,
                 const double* __restrict__ gates, const float* __restrict__ CT,
                 const float* __restrict__ nS, const double* __restrict__ mS,
                 float* __restrict__ rows, float* __restrict__ dq, int S, int H, int hd, int L,
                 int nc, int Sp, float scale, int has_state) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * (WNT / 32) + warp, c = blockIdx.y, bh = blockIdx.z;
  if (j >= L) return;
  const int b = bh / H, hh = bh - b * H, nu = hd / 32, p0 = c * L, p = p0 + j;
  const size_t rs = (size_t)H * hd, head = (size_t)b * S * rs + (size_t)hh * hd;
  const double* gF = gates + (size_t)bh * 3 * Sp + p0;
  const double* gM = gF + Sp;
  const double* gI = gF + 2 * Sp;
  const float* rw = rows + (size_t)bh * NR * Sp + p0;
  const double m_c = mS[(size_t)bh * nc + c];
  const double m_inter = gF[j] + m_c, mj = fmax(m_inter, gM[j]);
  const float inter = (float)exp(m_inter - mj);
  const float den = rw[kDenom * Sp + j], dqn = rw[kDqn * Sp + j];
  const bool real = p < S;
  float qr[MAX_U], dr[MAX_U], acc[MAX_U], kr[MAX_U];
  load_lane(qr, q + head + (size_t)p * rs, nu, lane, real);
  load_lane(dr, dh + head + (size_t)p * rs, nu, lane, real);
#pragma unroll
  for (int u = 0; u < MAX_U; ++u) acc[u] = 0.f;
  float rsum = 0.f;
  for (int m = 0; m <= j && p0 + m < S; ++m) {
    const size_t km = head + (size_t)(p0 + m) * rs;
    load_lane(kr, k + km, nu, lane, true);
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < MAX_U; ++u)
      if (u < nu) s = fmaf(qr[u], kr[u], s);
    s = warp_sum(s);
    const float P = lane_dot(dr, v + km, nu, lane);
    const float dd = (float)exp(((gF[j] - gF[m]) + gI[m]) - mj);
    const float t = P / den + dqn, ds = dd * t;
    rsum = fmaf(s * scale * dd, t, rsum);
#pragma unroll
    for (int u = 0; u < MAX_U; ++u)
      if (u < nu) acc[u] = fmaf(ds, kr[u], acc[u]);
  }
  if (lane == 0) rows[((size_t)bh * NR + kRowsum) * Sp + p0 + j] = rsum;
  if (!real) return;
  float x[MAX_U];
#pragma unroll
  for (int u = 0; u < MAX_U; ++u) x[u] = 0.f;
  if (has_state || c > 0) {  // X = dh·C_cᵀ
    const float* ct = CT + ((size_t)bh * nc + c) * hd * hd;  // [e][d]
    for (int e = 0; e < hd; ++e) {
      const float de = dh[head + (size_t)p * rs + e];
#pragma unroll
      for (int u = 0; u < MAX_U; ++u)
        if (u < nu) x[u] = fmaf(de, ct[(size_t)e * hd + lane + 32 * u], x[u]);
    }
  }
  const float* n_c = nS + ((size_t)bh * nc + c) * hd;
  const float cx = inter / den, di = dqn * inter;
#pragma unroll
  for (int u = 0; u < MAX_U; ++u)
    if (u < nu) {
      const int col = lane + 32 * u;
      dq[head + (size_t)p * rs + col] = scale * (acc[u] + cx * x[u] + di * n_c[col]);
    }
}

// ---- float32 route: dk, dv, a warp per key row --------------------------------------------
__global__ void __launch_bounds__(WNT)
mlstm_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dh,
                   const double* __restrict__ gates, const double* __restrict__ mS,
                   float* __restrict__ rows, const float* __restrict__ dCE,
                   const float* __restrict__ dnE, float* __restrict__ dlsc,
                   float* __restrict__ dk, float* __restrict__ dv, int S, int H, int hd, int L,
                   int nc, int Sp, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * (WNT / 32) + warp, c = blockIdx.y, bh = blockIdx.z;
  if (m >= L) return;
  const int b = bh / H, hh = bh - b * H, nu = hd / 32, p0 = c * L, p = p0 + m;
  const size_t rs = (size_t)H * hd, head = (size_t)b * S * rs + (size_t)hh * hd;
  const double* gF = gates + (size_t)bh * 3 * Sp + p0;
  const double* gM = gF + Sp;
  const double* gI = gF + 2 * Sp;
  const float* rw = rows + (size_t)bh * NR * Sp + p0;
  const double m_c = mS[(size_t)bh * nc + c];
  const bool real = p < S;
  float kr[MAX_U], vr[MAX_U], dka[MAX_U], dva[MAX_U], ql[MAX_U], dl[MAX_U];
  load_lane(kr, k + head + (size_t)p * rs, nu, lane, real);
  load_lane(vr, v + head + (size_t)p * rs, nu, lane, real);
#pragma unroll
  for (int u = 0; u < MAX_U; ++u) dka[u] = dva[u] = 0.f;
  float csum = 0.f;
  for (int l = m; l < L && p0 + l < S && real; ++l) {
    const size_t at = head + (size_t)(p0 + l) * rs;
    load_lane(ql, q + at, nu, lane, true);
    load_lane(dl, dh + at, nu, lane, true);
    float s = 0.f, P = 0.f;
#pragma unroll
    for (int u = 0; u < MAX_U; ++u)
      if (u < nu) {
        s = fmaf(ql[u], kr[u], s);
        P = fmaf(dl[u], vr[u], P);
      }
    s = warp_sum(s);
    P = warp_sum(P);
    const double mj = fmax(gF[l] + m_c, gM[l]);
    const float dd = (float)exp(((gF[l] - gF[m]) + gI[m]) - mj);
    const float den = rw[kDenom * Sp + l], w = s * scale * dd;
    const float t = P / den + rw[kDqn * Sp + l], wd = w / den, ds = dd * t;
    csum = fmaf(w, t, csum);
#pragma unroll
    for (int u = 0; u < MAX_U; ++u)
      if (u < nu) {
        dka[u] = fmaf(ds, ql[u], dka[u]);
        dva[u] = fmaf(wd, dl[u], dva[u]);
      }
  }
  // the state update: dCv = dCE_c·v + dnE_c, dk += sc dCv, dv += (k sc)·dCE_c
  const double FL = gF[L - 1];
  const float sc = (float)exp(((FL - gF[m]) + gI[m]) - fmax(FL + m_c, gM[L - 1]));
  const float* dce = dCE + ((size_t)bh * nc + c) * hd * hd;  // [d][e]
  const float* dne = dnE + ((size_t)bh * nc + c) * hd;
  float cv[MAX_U];
#pragma unroll
  for (int u = 0; u < MAX_U; ++u) cv[u] = u < nu ? dne[lane + 32 * u] : 0.f;
  if (real) {
    const float* vrow = v + head + (size_t)p * rs;
    const float* krow = k + head + (size_t)p * rs;
    for (int e = 0; e < hd; ++e) {
      const float ve = vrow[e];
#pragma unroll
      for (int u = 0; u < MAX_U; ++u)
        if (u < nu) cv[u] = fmaf(ve, dce[(size_t)(lane + 32 * u) * hd + e], cv[u]);
    }
    for (int d = 0; d < hd; ++d) {
      const float kd = krow[d] * sc;
#pragma unroll
      for (int u = 0; u < MAX_U; ++u)
        if (u < nu) dva[u] = fmaf(kd, dce[(size_t)d * hd + lane + 32 * u], dva[u]);
    }
  }
  float ld = 0.f;
#pragma unroll
  for (int u = 0; u < MAX_U; ++u)
    if (u < nu) ld = fmaf(kr[u], cv[u], ld);
  ld = warp_sum(ld);
  if (lane == 0) {
    dlsc[(size_t)bh * Sp + p0 + m] = sc * ld;
    rows[((size_t)bh * NR + kColsum) * Sp + p0 + m] = csum;
  }
  if (!real) return;
#pragma unroll
  for (int u = 0; u < MAX_U; ++u)
    if (u < nu) {
      const int col = lane + 32 * u;
      dk[head + (size_t)p * rs + col] = fmaf(sc, cv[u], scale * dka[u]);
      dv[head + (size_t)p * rs + col] = dva[u];
    }
}

// ---- the gate phase (both routes): dig, dfg -------------------------------------------
// G: the gates' type (float for bf16, double for float32). Two launches, a
// block per (chunk, B·H) each. gsc (G) [B·H, 2, Sp] each row's dig and dF
// before the cross-chunk carry, then [B·H, nc, NGS] each chunk's scalars.
enum { kParts = 0, kBase = 1, kCarried = 2, kTopAt = 3, NGS = 4 };

// a block's sum of one value a thread, in one order (warp trees, then the
// warps in turn); every thread gets it
template <typename G>
__device__ __forceinline__ G gate_block_sum(G x, G* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  G s = 0;
#pragma unroll
  for (int w = 0; w < GATE_NT / 32; ++w) s += red[w];
  return s;
}

// Σ_x p[x stride], x < n <= MAX_PARTS, in order (the loads issued together)
constexpr int MAX_PARTS = 8;
__device__ __forceinline__ float partial_sum(const float* __restrict__ p, int n, int stride) {
  float v[MAX_PARTS];
#pragma unroll
  for (int x = 0; x < MAX_PARTS; ++x) v[x] = x < n ? p[(size_t)x * stride] : 0.f;
  float s = 0.f;
#pragma unroll
  for (int x = 0; x < MAX_PARTS; ++x)
    if (x < n) s += v[x];
  return s;
}

// Per chunk: each row's star column (its largest weight: the first i <= j
// with logD_ji = m_intra_j), its residual (Σ dlogD + dinter·inter − R) to
// that column where the intra-chunk stabiliser won (fix: summed in row
// order), dig = colsum − fix + dlsc and dF = R − colsum + fix − dlsc before
// the carry; the chunk's parts (Σ dlsc + decay·Σ ddp), base (Σ dinter·inter
// − Σ residuals the inter-chunk stabiliser took + decay·Σ ddp), whether
// m_next carried m_c, and its largest write (top_at). cols: ncs partials a
// row at stride Sp (bh stride cstride), summed in order; dlsc: ncol.
template <typename G>
__global__ void __launch_bounds__(GATE_NT)
mlstm_bwd_gate_chunk(const G* __restrict__ gates, const G* __restrict__ mS,
          const float* __restrict__ rows, const float* __restrict__ cols, int ncs,
          size_t cstride, const float* __restrict__ dlsc, int ncol,
          const float* __restrict__ ddp, int NP, G* __restrict__ gsc, int L, int nc, int Sp) {
  __shared__ G sF[MAX_L], sMi[MAX_L], sIg[MAX_L], sRes[MAX_L], sRed[GATE_NT / 32];
  __shared__ int sStar[MAX_L], sRedI[GATE_NT / 32];
  const int c = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x, p0 = c * L;
  const G* g0 = gates + (size_t)bh * 3 * Sp + p0;
  const float* rw = rows + (size_t)bh * NR * Sp + p0;
  for (int j = tid; j < L; j += GATE_NT) {
    sF[j] = g0[j];
    sMi[j] = g0[Sp + j];
    sIg[j] = g0[2 * Sp + j];
  }
  __syncthreads();
  const G m_c = mS[(size_t)bh * nc + c];
  const G FL = sF[L - 1], top = sMi[L - 1];
  G tb = 0, tl = 0;
  int top_at = L;
  for (int j = tid; j < L; j += GATE_NT) {
    const G mint = sF[j] + m_c;
    const G res = ((G)rw[kRowsum * Sp + j] + (G)rw[kDi * Sp + j]) - (G)rw[kR * Sp + j];
    int star = j;
    for (int i = 0; i <= j; ++i)
      if ((sF[j] - sF[i]) + sIg[i] == sMi[j]) {
        star = i;
        break;
      }
    sStar[j] = sMi[j] >= mint ? star : -1;
    sRes[j] = res;
    tb += (G)rw[kDi * Sp + j] - (mint > sMi[j] ? res : (G)0);
    tl += (G)partial_sum(dlsc + (size_t)bh * ncol * Sp + p0 + j, ncol, Sp);
    if (top_at == L && (FL - sF[j]) + sIg[j] == top) top_at = j;
  }
  __syncthreads();
  G* out = gsc + (size_t)bh * 2 * Sp + p0;
  for (int i = tid; i < L; i += GATE_NT) {
    G fix = 0;
    for (int j = i; j < L; ++j)
      if (sStar[j] == i) fix += sRes[j];
    const float col = partial_sum(cols + bh * cstride + p0 + i, ncs, Sp);
    const float dl = partial_sum(dlsc + (size_t)bh * ncol * Sp + p0 + i, ncol, Sp);
    out[i] = ((G)col - fix) + (G)dl;
    out[Sp + i] = (((G)rw[kR * Sp + i] - (G)col) + fix) - (G)dl;
  }
  // the chunk's scalars
  tb = gate_block_sum(tb, sRed);
  tl = gate_block_sum(tl, sRed);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) top_at = min(top_at, __shfl_xor_sync(0xffffffffu, top_at, o));
  if ((tid & 31) == 0) sRedI[tid >> 5] = top_at;
  G dd = 0;
  if (tid < 32) {
#pragma unroll 8
    for (int p = tid; p < NP; p += 32) dd += (G)ddp[((size_t)bh * nc + c) * NP + p];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dd += __shfl_xor_sync(0xffffffffu, dd, o);
  }
  __syncthreads();
  if (tid == 0) {
    int at = L - 1;
    for (int w = 0; w < GATE_NT / 32; ++w) at = min(at, sRedI[w]);
    const G m_next = FL + m_c > top ? FL + m_c : top;
    const G decay = gexp((FL + m_c) - m_next);
    G* sc = gsc + (size_t)gridDim.y * 2 * Sp + ((size_t)bh * nc + c) * NGS;
    sc[kParts] = tl + dd * decay;
    sc[kBase] = tb + dd * decay;
    sc[kCarried] = FL + m_c >= top ? (G)1 : (G)0;
    sc[kTopAt] = (G)at;
  }
}

// Per chunk, after every chunk's scalars: the reverse carry of m_next's
// gradient from the last chunk to this one (G_c = dm − parts_c; to the
// chunk's largest write unless m_next carried m_c, then on to the chunk
// before), the tail parts_c + G_c into the chunk's last dF, dig, and dfg =
// revcumsum(dF)·σ(−fg) by a block scan in one order. A thread holds rows
// 2t, 2t + 1.
template <typename G>
__global__ void __launch_bounds__(GATE_NT)
mlstm_bwd_gate_rows(const float* __restrict__ fg, const float* __restrict__ dmp, int NP,
          const G* __restrict__ gsc, float* __restrict__ dig, float* __restrict__ dfg, int S,
          int H, int L, int nc, int Sp, int has_dstate) {
  __shared__ G sAt, sTail, sWarp[GATE_NT / 32];
  __shared__ int sTopAt;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, p0 = c * L;
  if (tid < 32) {
    G dm = 0;
    if (has_dstate) {
#pragma unroll 8
      for (int p = tid; p < NP; p += 32) dm += (G)dmp[(size_t)bh * NP + p];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dm += __shfl_xor_sync(0xffffffffu, dm, o);
    }
    if (tid == 0) {
      const G* sc = gsc + (size_t)gridDim.y * 2 * Sp + (size_t)bh * nc * NGS;
      for (int cc = nc - 1;; --cc) {
        const G* s = sc + (size_t)cc * NGS;
        const G Gc = dm - s[kParts];
        const bool carried = s[kCarried] != (G)0;
        if (cc == c) {
          sAt = carried ? (G)0 : Gc;
          sTail = s[kParts] + Gc;
          sTopAt = (int)s[kTopAt];
          break;
        }
        dm = s[kBase] + (carried ? Gc : (G)0);
      }
    }
  }
  __syncthreads();
  const G* loc = gsc + (size_t)bh * 2 * Sp + p0;
  G x[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = 2 * tid + u;
    x[u] = 0;
    if (j >= L) continue;
    const G at = j == sTopAt ? sAt : (G)0;
    x[u] = loc[Sp + j] - at;
    if (j == L - 1) x[u] += sTail;
    if (p0 + j < S) dig[((size_t)b * S + p0 + j) * H + hh] = (float)(loc[j] + at);
  }
  // suffix sums: within the thread, across the warp's lanes, then the warps after
  const G s0 = x[0] + x[1];
  G incl = s0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const G nb = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += nb;
  }
  G excl = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) excl = 0;
  if (lane == 0) sWarp[warp] = incl;
  __syncthreads();
  G after = 0;
  for (int w = GATE_NT / 32 - 1; w > warp; --w) after += sWarp[w];
  const G r1 = x[1] + (excl + after);
  const G r0 = x[0] + r1;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = 2 * tid + u, p = p0 + j;
    if (j >= L || p >= S) continue;
    const size_t at = ((size_t)b * S + p) * H + hh;
    dfg[at] = (float)((u == 0 ? r0 : r1) / ((G)1 + gexp((G)fg[at])));
  }
}

}  // namespace

namespace repro {
int mlstm_chunk_bwd_wgmma(const void* q, const void* k, const void* v, const void* dh,
                          const float* gates, const float* CT, const float* nS,
                          const float* mS, const float* dCout, const float* dnout,
                          const float* Cend, const float* nend, void* dq, void* dk, void* dv,
                          float* rows, float* dlsc, float* dCE, float* dnE, float* ddp,
                          float* dmp, float* xs, float* xq, float* cols, void* pt, float* sp,
                          int B, int S, int H, int hd, int L, float scale, int has_state,
                          cudaStream_t st);
}  // namespace repro

// the gate phase's two launches (G: the gates' type)
template <typename G>
static int gate_phase(const float* fg, const G* gates, const G* mS, const float* rows,
                      const float* cols, int ncs, size_t cstride, const float* dlsc, int ncol,
                      const float* ddp, const float* dmp, int NP, G* gsc, float* dig,
                      float* dfg, int BH, int S, int H, int L, int nc, int Sp, int has_dstate,
                      cudaStream_t st) {
  cudaError_t e;
  mlstm_bwd_gate_chunk<G><<<dim3(nc, BH), GATE_NT, 0, st>>>(gates, mS, rows, cols, ncs, cstride,
                                                            dlsc, ncol, ddp, NP, gsc, L, nc, Sp);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  mlstm_bwd_gate_rows<G><<<dim3(nc, BH), GATE_NT, 0, st>>>(fg, dmp, NP, gsc, dig, dfg, S, H, L,
                                                           nc, Sp, has_dstate);
  return (int)cudaGetLastError();
}

// The gradient of mlstm_chunk_fwd at (q, k, v, ig, fg), given dh [B, S, H,
// hd] (q's dtype) and the state out's gradient dC [B, H, hd, hd], dn [B, H,
// hd] float32 (either null: 0) with the state out C, n (Cend, nend; read
// only where the gradient is given); the state in held constant. The
// forward's saved chunk start states: bf16: gates [B·H, 3, Sp], CT
// [B·H, nc, hd, hd] (C_cᵀ, TF32), nS [B·H, nc, hd], mS [B·H, nc] float32;
// float32: gates float64 scratch [B·H, 3, Sp] this call fills, CT, nS
// float32 and mS float64 as the float32 forward saved them. Outputs dq, dk,
// dv (q's dtype) and dig, dfg [B, S, H] float32; float32 scratch rows
// [B·H, 6, Sp], dlsc [B·H, ncol, Sp], dCE [B·H, nc, hd, hd], dnE [B·H, nc,
// hd], ddp [B·H, nc, NP], dmp [B·H, NP] (bf16: ncol = hd / 64, NP = (hd /
// 32)^2 + 1; float32: ncol = 1, NP = ceil((hd^2 + hd) / 256)); bf16 only
// (float32: null) xs [2, B·H, Sp, hd], xq [B·H, 2, ncol, Sp], cols [B·H,
// ntile, Sp], sp [B·H, nc, T, 2, 64 x 64] and the bf16 pair tiles pt [2, B·H,
// nc, T, 64 x 64] (T = ntile (ntile + 1) / 2, ntile = ceil(L / 64)); float64
// gsc [B·H, 2 Sp + 4 nc] (the gate
// phase's). All contiguous, outputs distinct from inputs; hd a multiple of
// 64 (bf16) or 32 (float32) up to 512, 1 <= L <= 512. Returns
// cudaGetLastError() of the launches.
extern "C" int mlstm_chunk_bwd(const void* q, const void* k, const void* v, const void* ig,
                               const void* fg, const void* dh, const void* dC, const void* dn,
                               const void* Cend, const void* nend, void* gates,
                               const void* CT, const void* nS, const void* mS, void* dq,
                               void* dk, void* dv, void* dig, void* dfg, void* rows,
                               void* dlsc, void* dCE, void* dnE, void* ddp, void* dmp,
                               void* xs, void* xq, void* cols, void* pt, void* sp, void* gsc, int B,
                               int S, int H, int hd, int L, float scale, int has_state,
                               int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (hd % 32 != 0 || hd > 512 || L < 1 || L > MAX_L || gates == nullptr || CT == nullptr ||
      nS == nullptr || mS == nullptr || gsc == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BH = B * H, nc = (S + L - 1) / L, Sp = nc * L;
  const int has_dstate = dC != nullptr || dn != nullptr;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  cudaError_t e;
  if (dtype == repro::kBF16) {
    if (hd % 64 != 0 || xs == nullptr || xq == nullptr || cols == nullptr || pt == nullptr ||
        sp == nullptr)
      return (int)cudaErrorInvalidValue;
    const int ncol = hd / 64, ntile = (L + 63) / 64, NP = (hd / 32) * (hd / 32) + 1;
    int err = repro::mlstm_chunk_bwd_wgmma(
        q, k, v, dh, f(gates), f(CT), f(nS), f(mS), f(dC), f(dn), f(Cend), f(nend), dq, dk, dv,
        w(rows), w(dlsc), w(dCE), w(dnE), w(ddp), w(dmp), w(xs), w(xq), w(cols), pt, w(sp), B, S,
        H, hd, L, scale, has_state, st);
    if (err != 0) return err;
    return gate_phase<float>(f(fg), f(gates), f(mS), f(rows), f(cols), ntile,
                             (size_t)ntile * Sp, f(dlsc), ncol, f(ddp), f(dmp), NP,
                             static_cast<float*>(gsc), w(dig), w(dfg), BH, S, H, L, nc, Sp,
                             has_dstate, st);
  }
  if (dtype != repro::kF32) return (int)cudaErrorInvalidValue;
  double* g64 = static_cast<double*>(gates);
  const double* m64 = static_cast<const double*>(mS);
  const int NP = (hd * hd + hd + CARRY_NT - 1) / CARRY_NT;
  mlstm_bwd_gates_f64<<<dim3(nc, BH), GATE_NT, 0, st>>>(f(ig), f(fg), g64, S, H, L, Sp);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const dim3 rgrid((L + WNT / 32 - 1) / (WNT / 32), nc, BH);
  mlstm_bwd_rows_f32<<<rgrid, WNT, 0, st>>>(f(q), f(k), f(v), f(dh), g64, f(CT), f(nS), m64,
                                            w(rows), S, H, hd, L, nc, Sp, scale, has_state);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  mlstm_bwd_carry_f32<<<dim3(NP, BH), CARRY_NT, 0, st>>>(f(q), f(dh), g64, f(CT), f(nS), m64,
                                                         f(rows), f(dC), f(dn), f(Cend),
                                                         f(nend), w(dCE), w(dnE), w(ddp),
                                                         w(dmp), S, H, hd, L, nc, Sp, scale,
                                                         has_state);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  mlstm_bwd_dq_f32<<<rgrid, WNT, 0, st>>>(f(q), f(k), f(v), f(dh), g64, f(CT), f(nS), m64,
                                          w(rows), w(dq), S, H, hd, L, nc, Sp, scale,
                                          has_state);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  mlstm_bwd_dkdv_f32<<<rgrid, WNT, 0, st>>>(f(q), f(k), f(v), f(dh), g64, m64, w(rows), f(dCE),
                                            f(dnE), w(dlsc), w(dk), w(dv), S, H, hd, L, nc, Sp,
                                            scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return gate_phase<double>(f(fg), g64, m64, f(rows), f(rows) + kColsum * Sp, 1,
                            (size_t)NR * Sp, f(dlsc), 1, f(ddp), f(dmp), NP,
                            static_cast<double*>(gsc), w(dig), w(dfg), BH, S, H, L, nc, Sp,
                            has_dstate, st);
}
