// sLSTM recurrence for Hopper (sm_90a): the scan over time and its gradient.
//
// Replaces the JAX package's sLSTM scan, src/repro/models/xlstm.py::
// slstm_scan (a lax.scan, one device loop; no Pallas kernel: XLA compiles
// the scan body) and its gradient, XLA's autodiff of the same scan. Per
// head h of H and time step t, with hd = D / H channels a head:
//
//   rec  = round_X(round_X(h_{t-1}) · R[h])        R [H, 4, hd, hd], float32 sums
//   g    = float(gates_x[t]) + float(rec)          gates i, f, z, o
//   m'   = max(g_f + m, g_i),  f' = exp(g_f + m - m'),  i' = exp(g_i - m')
//   c'   = f' c + i' tanh(g_z),  n' = f' n + i'
//   h'   = sigmoid(g_o) c' / max(n', 1e-6),  y_t = round_X(h')
//
// X is the activation dtype (bf16 or float32), the state (c, n, h, m) is
// float32, the empty state has m = -1e30. At a masked position the state
// is carried unchanged, but y_t is still the h' computed from g_t.
//
// What bounds it on an H100: neither bytes nor operations but the chain of
// S dependent steps. At xlstm-350m's train microbatch (B = 4, S = 1024,
// D = 1024, 4 heads of 256) the products are 8.6 GFLOP and the bytes ~42
// MB, ~0.013 ms of HBM time, while every step needs the whole h_{t-1} of
// its head before any of its gates. So one launch walks all S steps, and a
// step's latency is what counts.
//
// Design: one thread-block cluster per (head, group of up to NB = 8 rows).
// Its nc CTAs (8, or hd / 4 below hd = 32) each own hd / nc channels of
// the head for all four gates, hold R[h, :, :, their channels] in shared
// memory as float32 (128 KB at hd 256), loaded once, and keep c, n, h, m
// of their channels in registers, one thread a (row, channel). A step: the
// CTA's threads form rec for its channels from h_{t-1} in shared memory
// (CUDA-core FMAs; a bf16 product of two bf16 values is exact in float32),
// the owning threads update the state and write y, and each sends its
// round_X(h_t) into every peer's shared memory through distributed shared
// memory (DSMEM), into the buffer of the parity of t + 1; one cluster
// barrier a step then orders everything (a peer reads buffer t & 1 only
// after the barrier that ended step t - 1, and nobody writes it again
// before the barrier that ends step t).
//
// The gradient runs the same clusters backwards in time. It reads the
// forward's float32 g (kept by the forward for the gradient, so nothing is
// recomputed on the serial chain), the state stacks c, n, m after every
// step and dy, and walks t = S-1 .. 0 with the carries dc, dn, dh, dm of
// its channels in registers: through the output gate, the normaliser and
// its clamp, c and n, the exponential gates and the stabiliser m exactly as
// autograd differentiates the plain version (max's gradient split in half
// at a tie, as torch.maximum's and jnp.maximum's are). dg is rounded to X
// where autograd rounds it: once, for both d gates_x and the R product. The
// recurrent term dh_{t-1} = round_X(dg_t · R[h]ᵀ) needs every channel's dg
// for each of the head's hd outputs: each CTA forms the partial sum over its
// own channels for all hd outputs and sends each peer the slice it owns
// (DSMEM, double-buffered by parity), and the owner sums the nc partials in
// rank order after the barrier. Every sum has a fixed order: two calls give
// the same bits. dR = Σ_{b,t} round_X(h_{t-1})ᵀ dg_t is one batched product
// outside the kernel (the wrapper's torch.matmul).
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::from_f;
using repro::round_to;
using repro::to_f;

constexpr int kThreads = 256;
constexpr float kNegInf = repro::kNegInf;

// CTAs of a head's cluster: 8, or fewer where a CTA would own < 4 channels
__host__ __device__ inline int cluster_ctas(int hd) { return hd / 4 < 8 ? hd / 4 : 8; }

template <int NB>
__device__ __forceinline__ void load_rows(const float* p, float* v) {
  if constexpr (NB == 1) {
    v[0] = p[0];
  } else if constexpr (NB == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < NB; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + i);
      v[i] = a.x;
      v[i + 1] = a.y;
      v[i + 2] = a.z;
      v[i + 3] = a.w;
    }
  }
}

// R[head, g, d, rank * E + e] -> Rs[d * rs + g * E + e] (float32), rs =
// 4E + 1: the forward reads a row d across its threads' columns, the
// gradient a column across its threads' d, both without bank conflicts
template <typename T>
__device__ void load_r(float* Rs, const T* rg, int head, int rank, int hd, int E, int rs) {
  for (int i = threadIdx.x; i < 4 * hd * E; i += kThreads) {
    const int e = i % E, d = (i / E) % hd, g = i / (E * hd);
    Rs[d * rs + g * E + e] = to_f(rg[(((size_t)head * 4 + g) * hd + d) * hd + rank * E + e]);
  }
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// One step of the cell from g and the state before it: the plain
// version's operations in its order, each rounded on its own (no FMA
// contraction), as PyTorch's elementwise operators round them.
struct Cell {
  float a, m, fp, ip, tz, c, n, sg, nc, h;
  __device__ __forceinline__ Cell(const float* g, float c0, float n0, float m0) {
    a = __fadd_rn(g[1], m0);
    m = fmaxf(a, g[0]);
    fp = expf(__fsub_rn(a, m));
    ip = expf(__fsub_rn(g[0], m));
    tz = tanhf(g[2]);
    c = __fadd_rn(__fmul_rn(fp, c0), __fmul_rn(ip, tz));
    n = __fadd_rn(__fmul_rn(fp, n0), ip);
    sg = sigmoidf(g[3]);
    nc = fmaxf(n, 1e-6f);
    h = __fdiv_rn(__fmul_rn(sg, c), nc);
  }
};

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int NB>
__global__ void __launch_bounds__(kThreads, 1)
slstm_fwd(const T* __restrict__ gx, const T* __restrict__ rg, const float* __restrict__ c0,
          const float* __restrict__ n0, const float* __restrict__ h0,
          const float* __restrict__ m0, const uint8_t* __restrict__ mask,
          T* __restrict__ y, float* __restrict__ cs, float* __restrict__ ns,
          float* __restrict__ hs, float* __restrict__ ms, float* __restrict__ gs,
          int all, int B, int S, int H, int hd) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / nc, head = cid % H, row0 = (cid / H) * NB;
  const int E = hd / nc, cols = 4 * E, rs = cols + 1, D = H * hd;
  const int tid = threadIdx.x;
  extern __shared__ float smem[];
  float* Rs = smem;                        // [hd][rs]
  float* hb = Rs + hd * rs;                // [2][hd][NB]: round_X(h_{t-1})
  float* part = hb + 2 * hd * NB;          // [ksplit][NB][cols]
  load_r(Rs, rg, head, rank, hd, E, rs);
  for (int i = tid; i < hd * NB; i += kThreads) {
    const int d = i / NB, b = i % NB, row = row0 + b;
    hb[i] = (h0 != nullptr && row < B) ? round_to<T>(h0[(size_t)row * D + head * hd + d])
                                       : 0.f;
  }
  // the (row, channel) this thread keeps the state of
  const bool act = tid < NB * E;
  const int b = act ? tid / E : 0, e = tid % E, row = row0 + b;
  const bool valid = act && row < B;
  const int ch = head * hd + rank * E + e;
  float c = 0.f, n = 0.f, h = 0.f, m = kNegInf;
  if (valid && c0 != nullptr) {
    const size_t i = (size_t)row * D + ch;
    c = c0[i];
    n = n0[i];
    h = h0[i];
    m = m0[i];
  }
  // the product's split: column col of the CTA's 4E, d in [kp DR, kp DR + DR)
  const int ksplit = kThreads / cols, DR = hd / ksplit;
  const int col = tid % cols, kp = tid / cols;
  // a step's gates and mask, loaded one step ahead: their latency hides
  // behind the step before (the product, the exchange and the barrier)
  float gn[4] = {0.f, 0.f, 0.f, 0.f};
  bool keepn = true;
  auto load = [&](int t) {
    const size_t base = ((size_t)row * S + t) * 4 * D + ch;
#pragma unroll
    for (int q = 0; q < 4; ++q) gn[q] = to_f(gx[base + (size_t)q * D]);
    keepn = mask == nullptr || mask[(size_t)row * S + t] != 0;
  };
  if (valid) load(0);
  cluster.sync();                          // every CTA started, R and h_{-1} in place
  int par = 0;
  for (int t = 0; t < S; ++t) {
    float g[4] = {gn[0], gn[1], gn[2], gn[3]};
    const bool keep = keepn;
    if (valid && t + 1 < S) load(t + 1);
    {
      const float* hp = hb + par * hd * NB;
      float acc[NB];
#pragma unroll
      for (int r = 0; r < NB; ++r) acc[r] = 0.f;
      const int d0 = kp * DR;
#pragma unroll 4
      for (int d = d0; d < d0 + DR; ++d) {
        const float rv = Rs[d * rs + col];
        float hv[NB];
        load_rows<NB>(hp + d * NB, hv);
#pragma unroll
        for (int r = 0; r < NB; ++r) acc[r] = fmaf(hv[r], rv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < NB; ++r) part[(kp * NB + r) * cols + col] = acc[r];
    }
    __syncthreads();
    if (act) {
      if (valid) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float s = 0.f;
          for (int k = 0; k < ksplit; ++k) s += part[(k * NB + b) * cols + q * E + e];
          g[q] += round_to<T>(s);
        }
        const Cell cell(g, c, n, m);
        const size_t o = ((size_t)row * S + t) * D + ch;
        y[o] = from_f<T>(cell.h);
        if (gs != nullptr) {
          const size_t og = ((size_t)row * S + t) * 4 * D + ch;
#pragma unroll
          for (int q = 0; q < 4; ++q) gs[og + (size_t)q * D] = g[q];
        }
        if (keep) {
          c = cell.c;
          n = cell.n;
          h = cell.h;
          m = cell.m;
        }
        if (all) {
          cs[o] = c;
          ns[o] = n;
          hs[o] = h;
          ms[o] = m;
        }
      }
      const float hv = valid ? round_to<T>(h) : 0.f;
      float* dst = hb + (par ^ 1) * hd * NB + (rank * E + e) * NB + b;
      for (int j = 0; j < nc; ++j) *cluster.map_shared_rank(dst, j) = hv;
    }
    cluster.sync();
    par ^= 1;
  }
  if (valid && !all) {
    const size_t i = (size_t)row * D + ch;
    cs[i] = c;
    ns[i] = n;
    hs[i] = h;
    ms[i] = m;
  }
}

// ---------------------------------------------------------------------------
// gradient
// ---------------------------------------------------------------------------

template <typename T, int NB>
__global__ void __launch_bounds__(kThreads, 1)
slstm_bwd(const float* __restrict__ gs, const T* __restrict__ rg, const float* __restrict__ cs,
          const float* __restrict__ ns, const float* __restrict__ ms,
          const float* __restrict__ c0, const float* __restrict__ n0,
          const float* __restrict__ m0, const uint8_t* __restrict__ mask,
          const T* __restrict__ dy, const float* __restrict__ dcT,
          const float* __restrict__ dnT, const float* __restrict__ dhT,
          const float* __restrict__ dmT, T* __restrict__ dgx, float* __restrict__ dc0,
          float* __restrict__ dn0, float* __restrict__ dh0, float* __restrict__ dm0, int B,
          int S, int H, int hd) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / nc, head = cid % H, row0 = (cid / H) * NB;
  const int E = hd / nc, cols = 4 * E, rs = cols + 1, D = H * hd;
  const int tid = threadIdx.x;
  const int ksplit = kThreads / hd, KR = cols / ksplit;
  extern __shared__ float smem[];
  float* Rs = smem;                        // [hd][rs]
  float* dgs = Rs + hd * rs;               // [cols][NB]: round_X(dg_t)
  float* part = dgs + cols * NB;           // [ksplit][NB][hd]
  float* slots = part + ksplit * NB * hd;  // [2][nc][NB][E]: peers' partial dh
  load_r(Rs, rg, head, rank, hd, E, rs);
  const bool act = tid < NB * E;
  const int b = act ? tid / E : 0, e = tid % E, row = row0 + b;
  const bool valid = act && row < B;
  const int ch = head * hd + rank * E + e;
  float Dc = 0.f, Dn = 0.f, Dh = 0.f, Dm = 0.f;
  if (valid && dcT != nullptr) {
    const size_t i = (size_t)row * D + ch;
    Dc = dcT[i];
    Dn = dnT[i];
    Dh = dhT[i];
    Dm = dmT[i];
  }
  const int dd = tid % hd, kp = tid / hd;   // the product: output d, k slice kp
  // a step's inputs (g, the state before it, dy, the mask), loaded one step
  // ahead: none depends on the carries
  struct In {
    float g[4], cp, np, mp, dy;
    bool keep;
  } nx;
  auto load = [&](int t) {
    const size_t o = ((size_t)row * S + t) * D + ch;
    const size_t og = ((size_t)row * S + t) * 4 * D + ch;
#pragma unroll
    for (int q = 0; q < 4; ++q) nx.g[q] = gs[og + (size_t)q * D];
    nx.cp = 0.f;
    nx.np = 0.f;
    nx.mp = kNegInf;
    if (t > 0) {
      nx.cp = cs[o - D];
      nx.np = ns[o - D];
      nx.mp = ms[o - D];
    } else if (c0 != nullptr) {
      nx.cp = c0[(size_t)row * D + ch];
      nx.np = n0[(size_t)row * D + ch];
      nx.mp = m0[(size_t)row * D + ch];
    }
    nx.dy = to_f(dy[o]);
    nx.keep = mask == nullptr || mask[(size_t)row * S + t] != 0;
  };
  if (valid) load(S - 1);
  cluster.sync();
  for (int t = S - 1; t >= 0; --t) {
    const int par = t & 1;
    float dhold = 0.f;                     // the carry's dh where the step kept it
    if (act) {
      float dg[4] = {0.f, 0.f, 0.f, 0.f};
      if (valid) {
        const In in = nx;
        if (t > 0) load(t - 1);
        const size_t og = ((size_t)row * S + t) * 4 * D + ch;
        const float* g = in.g;
        const float cp = in.cp, np = in.np;
        const bool keep = in.keep;
        const Cell f(g, cp, np, in.mp);
        float dhn = in.dy + (keep ? Dh : 0.f);
        float dcn = keep ? Dc : 0.f, dnn = keep ? Dn : 0.f, dmn = keep ? Dm : 0.f;
        // h' = (sg c') / nc
        const float q = f.sg * f.c;
        const float dq = dhn / f.nc;
        const float dnc = -dhn * ((q / f.nc) / f.nc);   // autograd's div backward
        const float dsg = dq * f.c;
        dcn += dq * f.sg;
        if (f.n >= 1e-6f) dnn += dnc;
        dg[3] = dsg * (1.f - f.sg) * f.sg;
        // c' = fp c + ip tz, n' = fp n + ip
        const float dfp = dcn * cp + dnn * np;
        const float dip = dcn * f.tz + dnn;
        dg[2] = dcn * f.ip * (1.f - f.tz * f.tz);
        const float ei = dip * f.ip, ef = dfp * f.fp;
        dg[0] = ei;
        dg[1] = ef;
        dmn -= ei;
        dmn -= ef;
        float dmp = ef;
        // m' = max(g_f + m, g_i)
        float da = 0.f;
        if (f.a > g[0]) {
          da = dmn;
        } else if (f.a < g[0]) {
          dg[0] += dmn;
        } else {
          da = 0.5f * dmn;
          dg[0] += 0.5f * dmn;
        }
        dg[1] += da;
        dmp += da;
        Dc = dcn * f.fp + (keep ? 0.f : Dc);
        Dn = dnn * f.fp + (keep ? 0.f : Dn);
        Dm = dmp + (keep ? 0.f : Dm);
        dhold = keep ? 0.f : Dh;
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          const T v = from_f<T>(dg[qq]);
          dgx[og + (size_t)qq * D] = v;
          dg[qq] = to_f(v);
        }
      }
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) dgs[(qq * E + e) * NB + b] = dg[qq];
    }
    __syncthreads();
    {
      float acc[NB];
#pragma unroll
      for (int r = 0; r < NB; ++r) acc[r] = 0.f;
      const int k0 = kp * KR;
#pragma unroll 4
      for (int k = k0; k < k0 + KR; ++k) {
        const float rv = Rs[dd * rs + k];
        float gv[NB];
        load_rows<NB>(dgs + k * NB, gv);
#pragma unroll
        for (int r = 0; r < NB; ++r) acc[r] = fmaf(gv[r], rv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < NB; ++r) part[(kp * NB + r) * hd + dd] = acc[r];
    }
    __syncthreads();
    for (int i = tid; i < NB * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      float s = 0.f;
      for (int k = 0; k < ksplit; ++k) s += part[(k * NB + r) * hd + d];
      float* dst = slots + ((par * nc + rank) * NB + r) * E + d % E;
      *cluster.map_shared_rank(dst, d / E) = s;
    }
    cluster.sync();
    if (valid) {
      float s = 0.f;
      for (int k = 0; k < nc; ++k) s += slots[((par * nc + k) * NB + b) * E + e];
      Dh = round_to<T>(s) + dhold;
    }
  }
  if (valid && dc0 != nullptr) {
    const size_t i = (size_t)row * D + ch;
    dc0[i] = Dc;
    dn0[i] = Dn;
    dh0[i] = Dh;
    dm0[i] = Dm;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// rows a cluster takes: the least power of two >= min(B, 8)
int rows_per_cluster(int B) { return B >= 5 ? 8 : B >= 3 ? 4 : B; }

template <typename Kern, typename... Args>
cudaError_t launch_cluster(Kern kern, int nc, int clusters, size_t smem, cudaStream_t st,
                           Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nc * clusters);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int NB>
cudaError_t fwd_nb(const void* gx, const void* rg, const float* c0, const float* n0,
                   const float* h0, const float* m0, const uint8_t* mask, void* y,
                   float* cs, float* ns, float* hs, float* ms, float* gs, int all, int B,
                   int S, int H, int hd, cudaStream_t st) {
  const int nc = cluster_ctas(hd), E = hd / nc, cols = 4 * E;
  const size_t smem = sizeof(float) * ((size_t)hd * (cols + 1) + 2 * hd * NB + kThreads * NB);
  const int clusters = H * ((B + NB - 1) / NB);
  return launch_cluster(slstm_fwd<T, NB>, nc, clusters, smem, st,
                        static_cast<const T*>(gx), static_cast<const T*>(rg), c0, n0, h0, m0,
                        mask, static_cast<T*>(y), cs, ns, hs, ms, gs, all, B, S, H, hd);
}

template <typename T, int NB>
cudaError_t bwd_nb(const float* gs, const void* rg, const float* cs, const float* ns,
                   const float* ms, const float* c0, const float* n0, const float* m0,
                   const uint8_t* mask, const void* dy, const float* dcT, const float* dnT,
                   const float* dhT, const float* dmT, void* dgx, float* dc0, float* dn0,
                   float* dh0, float* dm0, int B, int S, int H, int hd, cudaStream_t st) {
  const int nc = cluster_ctas(hd), E = hd / nc, cols = 4 * E, ksplit = kThreads / hd;
  const size_t smem = sizeof(float) * ((size_t)hd * (cols + 1) + cols * NB +
                                       ksplit * NB * hd + 2 * nc * NB * E);
  const int clusters = H * ((B + NB - 1) / NB);
  return launch_cluster(slstm_bwd<T, NB>, nc, clusters, smem, st, gs,
                        static_cast<const T*>(rg), cs, ns, ms, c0, n0, m0, mask,
                        static_cast<const T*>(dy), dcT, dnT, dhT, dmT, static_cast<T*>(dgx),
                        dc0, dn0, dh0, dm0, B, S, H, hd);
}

template <typename T>
cudaError_t fwd_t(const void* gx, const void* rg, const float* c0, const float* n0,
                  const float* h0, const float* m0, const uint8_t* mask, void* y, float* cs,
                  float* ns, float* hs, float* ms, float* gs, int all, int B, int S, int H,
                  int hd, cudaStream_t st) {
  switch (rows_per_cluster(B)) {
    case 1: return fwd_nb<T, 1>(gx, rg, c0, n0, h0, m0, mask, y, cs, ns, hs, ms, gs, all, B, S, H, hd, st);
    case 2: return fwd_nb<T, 2>(gx, rg, c0, n0, h0, m0, mask, y, cs, ns, hs, ms, gs, all, B, S, H, hd, st);
    case 4: return fwd_nb<T, 4>(gx, rg, c0, n0, h0, m0, mask, y, cs, ns, hs, ms, gs, all, B, S, H, hd, st);
    default: return fwd_nb<T, 8>(gx, rg, c0, n0, h0, m0, mask, y, cs, ns, hs, ms, gs, all, B, S, H, hd, st);
  }
}

template <typename T>
cudaError_t bwd_t(const float* gs, const void* rg, const float* cs, const float* ns,
                  const float* ms, const float* c0, const float* n0, const float* m0,
                  const uint8_t* mask, const void* dy, const float* dcT, const float* dnT,
                  const float* dhT, const float* dmT, void* dgx, float* dc0, float* dn0,
                  float* dh0, float* dm0, int B, int S, int H, int hd, cudaStream_t st) {
  switch (rows_per_cluster(B)) {
    case 1: return bwd_nb<T, 1>(gs, rg, cs, ns, ms, c0, n0, m0, mask, dy, dcT, dnT, dhT, dmT, dgx, dc0, dn0, dh0, dm0, B, S, H, hd, st);
    case 2: return bwd_nb<T, 2>(gs, rg, cs, ns, ms, c0, n0, m0, mask, dy, dcT, dnT, dhT, dmT, dgx, dc0, dn0, dh0, dm0, B, S, H, hd, st);
    case 4: return bwd_nb<T, 4>(gs, rg, cs, ns, ms, c0, n0, m0, mask, dy, dcT, dnT, dhT, dmT, dgx, dc0, dn0, dh0, dm0, B, S, H, hd, st);
    default: return bwd_nb<T, 8>(gs, rg, cs, ns, ms, c0, n0, m0, mask, dy, dcT, dnT, dhT, dmT, dgx, dc0, dn0, dh0, dm0, B, S, H, hd, st);
  }
}

bool supported(int hd) { return hd >= 16 && hd <= 256 && (hd & (hd - 1)) == 0; }

}  // namespace

// gates_x [B, S, 4, D] and r_gates [H, 4, hd, hd] in dtype (0 float32, 1
// bf16), D = H * hd, hd a power of two in [16, 256]; the state c0, n0, h0,
// m0 [B, D] float32, all four or none (none: 0, 0, 0, -1e30); mask [B, S]
// bool bytes or null; y [B, S, D] in dtype. all = 1: c, n, h, m are the
// stacks [B, S, D] float32 of the state after every step; all = 0: they
// are [B, D], the state after the last. gs [B, S, 4, D] float32 or null:
// the gates g the gradient reads. All contiguous on the device. Returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for an hd the
// kernel does not take).
extern "C" int slstm_scan_fwd(const void* gx, const void* rg, const void* c0, const void* n0,
                              const void* h0, const void* m0, const void* mask, void* y,
                              void* c, void* n, void* h, void* m, void* gs, int all, int B,
                              int S, int H, int hd, int dtype, void* stream) {
  if (!supported(hd)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  auto f = dtype == repro::kBF16 ? fwd_t<__nv_bfloat16> : fwd_t<float>;
  return (int)f(gx, rg, static_cast<const float*>(c0), static_cast<const float*>(n0),
                static_cast<const float*>(h0), static_cast<const float*>(m0),
                static_cast<const uint8_t*>(mask), y, static_cast<float*>(c),
                static_cast<float*>(n), static_cast<float*>(h), static_cast<float*>(m),
                static_cast<float*>(gs), all, B, S, H, hd, static_cast<cudaStream_t>(stream));
}

// gs [B, S, 4, D] float32 (the forward's g); r_gates as above; c, n, m
// [B, S, D] float32, the forward's states after every step; c0, n0, m0
// [B, D] float32 or null (the state the forward started from); mask as
// above; dy [B, S, D] in dtype; dc, dn, dh, dm [B, D] float32, the
// gradient of the last state, all four or none (0); dgx [B, S, 4, D] in
// dtype; dc0, dn0, dh0, dm0 [B, D] float32, the gradient of the first
// state, written when given. Returns cudaGetLastError() of the launch.
extern "C" int slstm_scan_bwd(const void* gs, const void* rg, const void* c, const void* n,
                              const void* m, const void* c0, const void* n0, const void* m0,
                              const void* mask, const void* dy, const void* dc,
                              const void* dn, const void* dh, const void* dm, void* dgx,
                              void* dc0, void* dn0, void* dh0, void* dm0, int B, int S, int H,
                              int hd, int dtype, void* stream) {
  if (!supported(hd)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  auto f = dtype == repro::kBF16 ? bwd_t<__nv_bfloat16> : bwd_t<float>;
  using cf = const float*;
  return (int)f(static_cast<cf>(gs), rg, static_cast<cf>(c), static_cast<cf>(n),
                static_cast<cf>(m), static_cast<cf>(c0), static_cast<cf>(n0),
                static_cast<cf>(m0), static_cast<const uint8_t*>(mask), dy,
                static_cast<cf>(dc), static_cast<cf>(dn), static_cast<cf>(dh),
                static_cast<cf>(dm), dgx, static_cast<float*>(dc0), static_cast<float*>(dn0),
                static_cast<float*>(dh0), static_cast<float*>(dm0), B, S, H, hd,
                static_cast<cudaStream_t>(stream));
}
