// Chunkwise stabilised mLSTM for Hopper (sm_90a): the C entry point, and the
// float32 route on the CUDA cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm_chunk.py::
// mlstm_chunk. Per chunk of L rows it does the math of that kernel's body
// (mlstm_chunk.py:30-74): cumulative log-sigmoid forget gate F, intra-chunk
// weights D_ji = exp(F_j - F_i + ig_i - m_j) for i <= j, output
// h = (q·C·inter + (q·kᵀ ⊙ D)·v) / max(|q·n_j|, exp(-m_j)), and the float32
// (C, n, m) state carried to the next chunk. Unlike the Pallas kernel it
// takes the state in and gives it out (the semantics of the JAX package's
// mlstm_chunkwise, src/repro/models/xlstm.py:98-103, 137-148), so one call
// serves prefill and extend. Rows past S pad the last chunk with ig = -1e30,
// fg = 30 and q = k = v = 0, as the Pallas wrapper pads.
//
// Two routes, chosen by dtype in mlstm_chunk_fwd: bf16 (every served model)
// runs the chunkwise-parallel form on the tensor cores
// (mlstm_chunk_wgmma.cu); float32 (the parity path, held to 2e-5, which
// TF32 cannot keep) runs the kernel below on the CUDA cores.
//
// The float32 kernel: at hd = 512, C is 512 x 512 float32 = 1 MiB per
// (row, head), far above a block's 227 KB of shared memory. But
// C[:, j0:j1] and h[:, j0:j1] depend only on the value columns j0:j1, while
// F, m, n and the weights D do not depend on the value column at all. So the
// value dimension splits across blocks: grid (B*H, hd/BV), each block keeps
// its hd x BV slice of C in shared memory and walks the chunks in order; F,
// m_j, n and the scores q·kᵀ are recomputed by every column block. q·n_j
// needs no hd-wide n_j: q·n_j = inter_j (q·n) + Σ_i w_ji with
// w = (q·kᵀ) ⊙ D. Its products and sums are float32 (the Pallas kernel's
// precision) on the CUDA cores, tiled 32 x 32 by query and key rows with the
// q tile resident in shared memory; its gates (F, m, the exponents) are
// float64 (see log_sigmoid below). The build uses no fast-math flags, so the
// max(|q·n_j|, exp(-m_j)) branch is the reference's.
#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int NT = 256;    // threads per block
constexpr int TQ = 32;     // query rows per tile
constexpr int TK = 32;     // key rows per tile
constexpr int DS = 32;     // head-dim slab of a key tile
constexpr int BV = 32;     // value columns per block
constexpr int KSTR = DS + 1;
constexpr int WSTR = TK + 1;

// The gates run in float64: F falls to ~-30 over a chunk of 256 rows, and
// float32's rounding of F and of the exponents (F_j - F_i) + ig_i - m_j
// (~4e-6 at that size) moves h by ~2e-5 where |h| reaches ~12, the size of
// the float32 bound. In float64 the route stays within ~5e-6 of the plain
// version run in float64; the products stay float32.
__device__ __forceinline__ double log_sigmoid(double x) {
  // jax.nn.log_sigmoid(x) = -softplus(-x)
  return -(fmax(-x, 0.0) + log1p(exp(-fabs(x))));
}

template <typename T>
__global__ void __launch_bounds__(NT)
mlstm_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ ig,
                   const float* __restrict__ fg, const float* __restrict__ C0,
                   const float* __restrict__ n0, const float* __restrict__ m0,
                   T* __restrict__ hout, float* __restrict__ Cout,
                   float* __restrict__ nout, float* __restrict__ mout,
                   float* __restrict__ CT, float* __restrict__ nS, double* __restrict__ mS,
                   int S, int H, int hd, int L, float scale) {
  const int bh = blockIdx.x, b = bh / H, hh = bh - b * H;
  const int c0 = blockIdx.y * BV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Lp = (L + TQ - 1) / TQ * TQ;
  const int QSTR = hd + 1;

  extern __shared__ double smem[];
  double* sF = smem;                   // [Lp] cumulative log forget gate
  double* sMj = sF + Lp;               // [Lp] stabiliser m_j
  float* sC = reinterpret_cast<float*>(sMj + Lp);  // [hd][BV]
  float* sN = sC + hd * BV;            // [hd]
  float* sQ = sN + hd;                 // [TQ][hd + 1], pre-scaled
  float* sK = sQ + TQ * QSTR;          // [TK][DS + 1]
  float* sV = sK + TK * KSTR;          // [TK][BV]
  float* sW = sV + TK * BV;            // [TQ][TK + 1]
  float* sIg = sW + TQ * WSTR;         // [Lp] input gate (log space)
  float* sInter = sIg + Lp;            // [Lp] exp(F_j + m - m_j)
  float* sEmj = sInter + Lp;           // [Lp] exp(-m_j)
  float* sSc = sEmj + Lp;              // [Lp] state-update weights
  __shared__ double sScal[2];          // m_next, decay

  const size_t row_stride = (size_t)H * hd;  // between positions
  const T* qb = q + (size_t)b * S * row_stride + (size_t)hh * hd;
  const T* kb = k + (size_t)b * S * row_stride + (size_t)hh * hd;
  const T* vb = v + (size_t)b * S * row_stride + (size_t)hh * hd;
  T* hb = hout + (size_t)b * S * row_stride + (size_t)hh * hd;
  const float* igb = ig + (size_t)b * S * H + hh;
  const float* fgb = fg + (size_t)b * S * H + hh;

  // ---- state in ------------------------------------------------------------
  const size_t cbase = (size_t)bh * hd * hd;
  for (int e = tid; e < hd * BV; e += NT) {
    const int d = e / BV, c = e - d * BV;
    sC[e] = C0 != nullptr ? C0[cbase + (size_t)d * hd + c0 + c] : 0.f;
  }
  for (int d = tid; d < hd; d += NT) sN[d] = n0 != nullptr ? n0[(size_t)bh * hd + d] : 0.f;
  double m = m0 != nullptr ? m0[bh] : kNegInf;

  const int nc = (S + L - 1) / L;
  for (int ci = 0; ci < nc; ++ci) {
    const int p0 = ci * L;
    __syncthreads();  // the previous chunk's state update is done
    if (CT != nullptr) {  // with_states: the chunk's start state, for the backward
      float* ct = CT + ((size_t)bh * nc + ci) * hd * hd;  // C_cᵀ [e][d]
      for (int e = tid; e < BV * hd; e += NT) {
        const int c = e / hd, d = e - c * hd;
        ct[(size_t)(c0 + c) * hd + d] = sC[d * BV + c];
      }
      if (blockIdx.y == 0) {
        for (int d = tid; d < hd; d += NT) nS[((size_t)bh * nc + ci) * hd + d] = sN[d];
        if (tid == 0) mS[(size_t)bh * nc + ci] = m;
      }
    }
    // ---- per-row gates: F (cumsum of log_sigmoid(fg)), ig -----------------
    for (int j = tid; j < Lp; j += NT) {
      const int p = p0 + j;
      const bool real = j < L && p < S;
      sF[j] = j < L ? log_sigmoid(real ? fgb[(size_t)p * H] : 30.0) : 0.0;
      sIg[j] = real ? igb[(size_t)p * H] : kNegInf;
    }
    __syncthreads();
    if (warp == 0) {  // inclusive scan of sF[0:L) by one warp
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
    // ---- per-row stabiliser m_j = max(F_j + m, max_{i<=j} F_j - F_i + ig_i)
    for (int j = tid; j < L; j += NT) {
      const double Fj = sF[j];
      double mi = kNegInf;
      for (int i = 0; i <= j; ++i) mi = fmax(mi, (Fj - sF[i]) + sIg[i]);
      const double m_inter = Fj + m;
      const double mj = fmax(m_inter, mi);
      sMj[j] = mj;
      sInter[j] = (float)exp(m_inter - mj);
      sEmj[j] = (float)exp(-mj);
    }
    __syncthreads();

    // ---- outputs, one tile of TQ query rows at a time ---------------------
    const int r = tid >> 3, l8 = tid & 7, cc = l8 * 4;  // row / 4 columns
    for (int jt = 0; jt < Lp / TQ; ++jt) {
      const int j0 = jt * TQ;
      __syncthreads();  // sQ of the previous tile is consumed
      for (int e = tid; e < TQ * hd; e += NT) {
        const int rr = e / hd, d = e - rr * hd;
        const int j = j0 + rr, p = p0 + j;
        sQ[rr * QSTR + d] =
            (j < L && p < S) ? repro::to_f(qb[(size_t)p * row_stride + d]) * scale : 0.f;
      }
      __syncthreads();
      // h_inter = q·C[:, cols] and this thread's share of q·n
      float hin[4] = {0.f, 0.f, 0.f, 0.f}, qn = 0.f;
      const float* qr = sQ + r * QSTR;
#pragma unroll 4
      for (int d = 0; d < hd; ++d) {
        const float qd = qr[d];
        const float4 cv = *reinterpret_cast<const float4*>(sC + d * BV + cc);
        hin[0] = fmaf(qd, cv.x, hin[0]);
        hin[1] = fmaf(qd, cv.y, hin[1]);
        hin[2] = fmaf(qd, cv.z, hin[2]);
        hin[3] = fmaf(qd, cv.w, hin[3]);
      }
      for (int d = l8; d < hd; d += 8) qn = fmaf(qr[d], sN[d], qn);
      // h_intra = (q·kᵀ ⊙ D)·v over the key tiles up to the diagonal
      float hia[4] = {0.f, 0.f, 0.f, 0.f}, wsum = 0.f;
      const int tr = tid >> 4, ti = tid & 15;  // 2 x 2 score micro-tile
      for (int it = 0; it <= jt; ++it) {
        const int i0 = it * TK;
        float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
        for (int d0 = 0; d0 < hd; d0 += DS) {
          __syncthreads();  // sK is consumed
          for (int e = tid; e < TK * DS; e += NT) {
            const int ii = e / DS, dd = e - ii * DS;
            const int i = i0 + ii, p = p0 + i;
            sK[ii * KSTR + dd] =
                (i < L && p < S) ? repro::to_f(kb[(size_t)p * row_stride + d0 + dd]) : 0.f;
          }
          __syncthreads();
          const float* q0r = sQ + (2 * tr) * QSTR + d0;
          const float* q1r = q0r + QSTR;
          const float* k0r = sK + (2 * ti) * KSTR;
          const float* k1r = k0r + KSTR;
#pragma unroll 8
          for (int dd = 0; dd < DS; ++dd) {
            const float a0 = q0r[dd], a1 = q1r[dd], b0 = k0r[dd], b1 = k1r[dd];
            s[0][0] = fmaf(a0, b0, s[0][0]);
            s[0][1] = fmaf(a0, b1, s[0][1]);
            s[1][0] = fmaf(a1, b0, s[1][0]);
            s[1][1] = fmaf(a1, b1, s[1][1]);
          }
        }
#pragma unroll
        for (int x = 0; x < 2; ++x) {
#pragma unroll
          for (int y = 0; y < 2; ++y) {
            const int rr = 2 * tr + x, ii = 2 * ti + y;
            const int j = j0 + rr, i = i0 + ii;
            float w = 0.f;
            if (i <= j && j < L) {
              const double logD = (sF[j] - sF[i]) + sIg[i];
              w = s[x][y] * expf((float)(logD - sMj[j]));
            }
            sW[rr * WSTR + ii] = w;
          }
        }
        for (int e = tid; e < TK * BV; e += NT) {
          const int ii = e / BV, c = e - ii * BV;
          const int i = i0 + ii, p = p0 + i;
          sV[e] = (i < L && p < S) ? repro::to_f(vb[(size_t)p * row_stride + c0 + c]) : 0.f;
        }
        __syncthreads();
        const float* wr = sW + r * WSTR;
#pragma unroll 8
        for (int ii = 0; ii < TK; ++ii) {
          const float w = wr[ii];
          const float4 vv = *reinterpret_cast<const float4*>(sV + ii * BV + cc);
          hia[0] = fmaf(w, vv.x, hia[0]);
          hia[1] = fmaf(w, vv.y, hia[1]);
          hia[2] = fmaf(w, vv.z, hia[2]);
          hia[3] = fmaf(w, vv.w, hia[3]);
        }
        for (int ii = l8; ii < TK; ii += 8) wsum += wr[ii];
        __syncthreads();  // sW / sV are consumed
      }
      // the 8 threads of row r are adjacent lanes
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        qn += __shfl_xor_sync(0xffffffffu, qn, o);
        wsum += __shfl_xor_sync(0xffffffffu, wsum, o);
      }
      const int j = j0 + r, p = p0 + j;
      if (j < L && p < S) {
        const float inter = sInter[j];
        const float denom = fmaxf(fabsf(inter * qn + wsum), sEmj[j]);
        T* hr = hb + (size_t)p * row_stride + c0 + cc;
#pragma unroll
        for (int e = 0; e < 4; ++e) hr[e] = repro::from_f<T>((hin[e] * inter + hia[e]) / denom);
      }
    }

    // ---- state to the end of the chunk ------------------------------------
    __syncthreads();
    const double FL = sF[L - 1];
    if (warp == 0) {
      double mx = FL + m;
      for (int i = lane; i < L; i += 32) mx = fmax(mx, (FL - sF[i]) + sIg[i]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) {
        sScal[0] = mx;
        sScal[1] = exp((FL + m) - mx);
      }
    }
    __syncthreads();
    const double m_next = sScal[0];
    const float decay = (float)sScal[1];
    for (int i = tid; i < Lp; i += NT)
      sSc[i] = i < L ? (float)exp(((FL - sF[i]) + sIg[i]) - m_next) : 0.f;
    for (int e = tid; e < hd * BV; e += NT) sC[e] *= decay;
    for (int d = tid; d < hd; d += NT) sN[d] *= decay;
    for (int i0 = 0; i0 < Lp; i0 += TK) {
      __syncthreads();  // sV / sK are consumed; sSc and the decay are written
      for (int e = tid; e < TK * BV; e += NT) {
        const int ii = e / BV, c = e - ii * BV;
        const int i = i0 + ii, p = p0 + i;
        sV[e] = (i < L && p < S) ? repro::to_f(vb[(size_t)p * row_stride + c0 + c]) : 0.f;
      }
      for (int d0 = 0; d0 < hd; d0 += DS) {
        __syncthreads();
        for (int e = tid; e < TK * DS; e += NT) {
          const int ii = e / DS, dd = e - ii * DS;
          const int i = i0 + ii, p = p0 + i;
          sK[ii * KSTR + dd] =
              (i < L && p < S) ? repro::to_f(kb[(size_t)p * row_stride + d0 + dd]) : 0.f;
        }
        __syncthreads();
        // C[d, cols] += Σ_i sc_i k_id v_i,cols for this thread's 4 elements
        const int dd = tid >> 3;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
        for (int ii = 0; ii < TK; ++ii) {
          const float sk = sSc[i0 + ii] * sK[ii * KSTR + dd];
          const float4 vv = *reinterpret_cast<const float4*>(sV + ii * BV + cc);
          acc[0] = fmaf(sk, vv.x, acc[0]);
          acc[1] = fmaf(sk, vv.y, acc[1]);
          acc[2] = fmaf(sk, vv.z, acc[2]);
          acc[3] = fmaf(sk, vv.w, acc[3]);
        }
        float4* cp = reinterpret_cast<float4*>(sC + (d0 + dd) * BV + cc);
        float4 cv = *cp;
        cv.x += acc[0];
        cv.y += acc[1];
        cv.z += acc[2];
        cv.w += acc[3];
        *cp = cv;
        if (tid < DS) {
          float an = 0.f;
          for (int ii = 0; ii < TK; ++ii) an = fmaf(sSc[i0 + ii], sK[ii * KSTR + tid], an);
          sN[d0 + tid] += an;
        }
      }
    }
    m = m_next;
  }

  // ---- state out -------------------------------------------------------------
  __syncthreads();
  for (int e = tid; e < hd * BV; e += NT) {
    const int d = e / BV, c = e - d * BV;
    Cout[cbase + (size_t)d * hd + c0 + c] = sC[e];
  }
  if (blockIdx.y == 0) {
    for (int d = tid; d < hd; d += NT) nout[(size_t)bh * hd + d] = sN[d];
    if (tid == 0) mout[bh] = (float)m;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ig, const void* fg,
           const void* C0, const void* n0, const void* m0, void* h, void* C, void* n,
           void* m, void* CT, void* nS, void* mS, int B, int S, int H, int hd, int L,
           float scale, cudaStream_t st) {
  const int Lp = (L + TQ - 1) / TQ * TQ;
  const size_t smem = sizeof(double) * 2 * Lp +
                      sizeof(float) * ((size_t)hd * BV + hd + TQ * (hd + 1) + TK * KSTR +
                                       TK * BV + TQ * WSTR + 4 * Lp);
  auto kern = mlstm_chunk_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, hd / BV);
  kern<<<grid, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(ig), static_cast<const float*>(fg),
      static_cast<const float*>(C0), static_cast<const float*>(n0),
      static_cast<const float*>(m0), static_cast<T*>(h), static_cast<float*>(C),
      static_cast<float*>(n), static_cast<float*>(m), static_cast<float*>(CT),
      static_cast<float*>(nS), static_cast<double*>(mS), S, H, hd, L, scale);
  return (int)cudaGetLastError();
}

}  // namespace

namespace repro {
int mlstm_chunk_wgmma(const void* q, const void* k, const void* v, const float* ig,
                      const float* fg, const float* C0, const float* n0, const float* m0,
                      void* h, float* C, float* n, float* m, float* gates, float* CT,
                      float* nS, float* mS, int B, int S, int H, int hd, int L, float scale,
                      cudaStream_t st);
}  // namespace repro

// q, k, v, h [B, S, H, hd] in one dtype (repro::DType); ig, fg [B, S, H]
// float32; C0/C [B, H, hd, hd], n0/n [B, H, hd], m0/m [B, H] float32 (the
// three inputs all null for a zero start); all contiguous on the device,
// the outputs distinct from the inputs. float32: hd a multiple of 32 up to
// 512. bf16: hd a multiple of 64 up to 512, and the float32 scratch of the
// three phases (gates [B·H, 3, nc·L], CT [B·H, nc, hd, hd], nS [B·H, nc, hd],
// mS [B·H, nc]). The float32 route takes gates null and CT, nS, mS null or,
// to keep each chunk's start state for the backward, CT [B·H, nc, hd, hd]
// (C_cᵀ), nS [B·H, nc, hd] float32 and mS [B·H, nc] float64. 1 <= L <= 512.
// Returns cudaGetLastError() of the launches.
extern "C" int mlstm_chunk_fwd(const void* q, const void* k, const void* v,
                               const void* ig, const void* fg, const void* C0,
                               const void* n0, const void* m0, void* h, void* C,
                               void* n, void* m, void* gates, void* CT, void* nS,
                               void* mS, int B, int S, int H, int hd, int L,
                               float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (hd % BV != 0 || hd > 512 || L < 1 || L > 512) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch<float>(q, k, v, ig, fg, C0, n0, m0, h, C, n, m, CT, nS, mS, B, S, H, hd, L,
                         scale, st);
  if (dtype == repro::kBF16) {
    if (gates == nullptr || CT == nullptr || nS == nullptr || mS == nullptr)
      return (int)cudaErrorInvalidValue;
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    return repro::mlstm_chunk_wgmma(
        q, k, v, f(ig), f(fg), f(C0), f(n0), f(m0), h, static_cast<float*>(C),
        static_cast<float*>(n), static_cast<float*>(m), static_cast<float*>(gates),
        static_cast<float*>(CT), static_cast<float*>(nS), static_cast<float*>(mS), B, S, H,
        hd, L, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
