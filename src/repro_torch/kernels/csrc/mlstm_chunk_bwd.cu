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
//   gate phase, a block per B·H, chunks from the last: each row's residual
//   (Σ dlogD + dinter·inter − R, R the exact row sum) to its largest weight
//   (its star column), each chunk's through m_next's reverse carry (G) to
//   its largest write or to the chunk before, then dig = colsum − fix + dlsc
//   (+ the carry) and dfg = revcumsum(dF)·σ(−fg). Every sum has one order.
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
// G: the gates' type (float for bf16, double for float32). rows, dlsc
// (ncol partials a row, summed in column order), ddp / dmp (NP partials of a
// chunk's decay gradient and of the state out's m gradient, in order).
template <typename G>
__global__ void __launch_bounds__(GATE_NT)
mlstm_bwd_gates(const float* __restrict__ fg, const G* __restrict__ gates, const G* __restrict__ mS,
          const float* __restrict__ rows, const float* __restrict__ dlsc,
          const float* __restrict__ ddp, const float* __restrict__ dmp,
          float* __restrict__ dig, float* __restrict__ dfg, int S, int H, int L, int nc, int Sp,
          int ncol, int NP, int has_dstate) {
  __shared__ G sF[MAX_L], sIg[MAX_L], sMi[MAX_L], sMint[MAX_L], sRes[MAX_L], sFix[MAX_L],
      sDF[MAX_L];
  __shared__ float sR[MAX_L], sDi[MAX_L], sCol[MAX_L], sDl[MAX_L];
  __shared__ int sStar[MAX_L];
  __shared__ G sDm, sAt, sTail;
  __shared__ int sTopAt;
  const int bh = blockIdx.x, b = bh / H, hh = bh - b * H, tid = threadIdx.x;
  const G* g0 = gates + (size_t)bh * 3 * Sp;
  const float* rw = rows + (size_t)bh * NR * Sp;
  if (tid == 0) {
    G dm = 0;
    if (has_dstate)
      for (int p = 0; p < NP; ++p) dm += (G)dmp[(size_t)bh * NP + p];
    sDm = dm;
  }
  for (int c = nc - 1; c >= 0; --c) {
    const int p0 = c * L;
    __syncthreads();
    for (int j = tid; j < L; j += GATE_NT) {
      sF[j] = g0[p0 + j];
      sMi[j] = g0[Sp + p0 + j];
      sIg[j] = g0[2 * Sp + p0 + j];
      sR[j] = rw[kR * Sp + p0 + j];
      sDi[j] = rw[kDi * Sp + p0 + j];
      sCol[j] = rw[kColsum * Sp + p0 + j];
      float dl = 0.f;
      for (int cc = 0; cc < ncol; ++cc) dl += dlsc[((size_t)bh * ncol + cc) * Sp + p0 + j];
      sDl[j] = dl;
    }
    __syncthreads();
    const G m_c = mS[(size_t)bh * nc + c];
    for (int j = tid; j < L; j += GATE_NT) {
      sMint[j] = sF[j] + m_c;
      sRes[j] = ((G)rw[kRowsum * Sp + p0 + j] + (G)sDi[j]) - (G)sR[j];
      int star = j;
      for (int i = 0; i <= j; ++i)
        if ((sF[j] - sF[i]) + sIg[i] == sMi[j]) {
          star = i;
          break;
        }
      sStar[j] = star;
      sFix[j] = 0;
    }
    __syncthreads();
    if (tid == 0) {
      for (int j = 0; j < L; ++j)
        if (sMi[j] >= sMint[j]) sFix[sStar[j]] += sRes[j];
      const G FL = sF[L - 1], top = sMi[L - 1];
      int top_at = L - 1;
      for (int j = 0; j < L; ++j)
        if ((FL - sF[j]) + sIg[j] == top) {
          top_at = j;
          break;
        }
      const G m_next = FL + m_c > top ? FL + m_c : top;
      const G decay = gexp((FL + m_c) - m_next);
      G dd = 0, dls = 0, base = 0;
      for (int p = 0; p < NP; ++p) dd += (G)ddp[((size_t)bh * nc + c) * NP + p];
      for (int j = 0; j < L; ++j) {
        dls += (G)sDl[j];
        base += (G)sDi[j];
        if (sMint[j] > sMi[j]) base -= sRes[j];
      }
      const G parts = dls + dd * decay;
      base += dd * decay;
      const bool carried = FL + m_c >= top;
      const G Gc = sDm - parts;
      sAt = carried ? (G)0 : Gc;
      sDm = base + (carried ? Gc : (G)0);
      sTopAt = top_at;
      sTail = parts + Gc;
    }
    __syncthreads();
    for (int j = tid; j < L; j += GATE_NT) {
      const G at = j == sTopAt ? sAt : (G)0;
      const G dg = (((G)sCol[j] - sFix[j]) + (G)sDl[j]) + at;
      G dF = ((((G)sR[j] - (G)sCol[j]) + sFix[j]) - (G)sDl[j]) - at;
      if (j == L - 1) dF += sTail;
      sDF[j] = dF;
      const int p = p0 + j;
      if (p < S) dig[((size_t)b * S + p) * H + hh] = (float)dg;
    }
    __syncthreads();
    if (tid == 0) {
      G run = 0;
      for (int j = L - 1; j >= 0; --j) {
        run += sDF[j];
        sDF[j] = run;
      }
    }
    __syncthreads();
    for (int j = tid; j < L; j += GATE_NT) {
      const int p = p0 + j;
      if (p < S) {
        const size_t at = ((size_t)b * S + p) * H + hh;
        dfg[at] = (float)(sDF[j] / ((G)1 + gexp((G)fg[at])));
      }
    }
  }
}

}  // namespace

namespace repro {
int mlstm_chunk_bwd_wgmma(const void* q, const void* k, const void* v, const void* dh,
                          const float* gates, const float* CT, const float* nS,
                          const float* mS, const float* dCout, const float* dnout,
                          const float* Cend, const float* nend, void* dq, void* dk, void* dv,
                          float* rows, float* dlsc, float* dCE, float* dnE, float* ddp,
                          float* dmp, float* xs, float* xq, int B, int S, int H, int hd,
                          int L, float scale, int has_state, cudaStream_t st);
}  // namespace repro

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
// hd], ddp [B·H, nc, NP], dmp [B·H, NP] (bf16: ncol = hd / 64, NP = ncol^2;
// float32: ncol = 1, NP = ceil((hd^2 + hd) / 256)); bf16 only (float32: null)
// xs [2, B·H, Sp, hd] and xq [B·H, 2, ncol, Sp]. All contiguous, outputs
// distinct from inputs; hd a multiple of 64 (bf16) or 32 (float32) up to
// 512, 1 <= L <= 512. Returns cudaGetLastError() of the launches.
extern "C" int mlstm_chunk_bwd(const void* q, const void* k, const void* v, const void* ig,
                               const void* fg, const void* dh, const void* dC, const void* dn,
                               const void* Cend, const void* nend, void* gates,
                               const void* CT, const void* nS, const void* mS, void* dq,
                               void* dk, void* dv, void* dig, void* dfg, void* rows,
                               void* dlsc, void* dCE, void* dnE, void* ddp, void* dmp,
                               void* xs, void* xq, int B, int S, int H, int hd, int L,
                               float scale, int has_state, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (hd % 32 != 0 || hd > 512 || L < 1 || L > MAX_L || gates == nullptr || CT == nullptr ||
      nS == nullptr || mS == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BH = B * H, nc = (S + L - 1) / L, Sp = nc * L;
  const int has_dstate = dC != nullptr || dn != nullptr;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  cudaError_t e;
  if (dtype == repro::kBF16) {
    if (hd % 64 != 0 || xs == nullptr || xq == nullptr) return (int)cudaErrorInvalidValue;
    const int ncol = hd / 64;
    int err = repro::mlstm_chunk_bwd_wgmma(
        q, k, v, dh, f(gates), f(CT), f(nS), f(mS), f(dC), f(dn), f(Cend), f(nend), dq, dk, dv,
        w(rows), w(dlsc), w(dCE), w(dnE), w(ddp), w(dmp), w(xs), w(xq), B, S, H, hd, L, scale,
        has_state, st);
    if (err != 0) return err;
    mlstm_bwd_gates<float><<<BH, GATE_NT, 0, st>>>(f(fg), f(gates), f(mS), f(rows), f(dlsc), f(ddp),
                                             f(dmp), w(dig), w(dfg), S, H, L, nc, Sp, ncol,
                                             ncol * ncol, has_dstate);
    return (int)cudaGetLastError();
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
  mlstm_bwd_gates<double><<<BH, GATE_NT, 0, st>>>(f(fg), g64, m64, f(rows), f(dlsc), f(ddp), f(dmp),
                                            w(dig), w(dfg), S, H, L, nc, Sp, 1, NP, has_dstate);
  return (int)cudaGetLastError();
}
