// TMA-fed bf16 attention tiles on Hopper (sm_90a), shared by the flash
// forward (flash_attention_wgmma.cu) and its backward
// (flash_attention_bwd_wgmma.cu): the shared-memory geometry of a head dim,
// the wgmma descriptors of a tile, mbarriers, the TMA load, and the host's
// tensor-map encoder.
//
// A tile is `rows` rows (positions) of one head, hd bf16 columns, stored as
// NCB column blocks of BC columns: rows of ROWB = min(2 hd, 128) bytes in
// the TMA swizzle of that width, which is the layout a wgmma descriptor of
// the same swizzle names. The same tile serves as a K-major operand (its
// rows are the product's M or N: Q and K in Q·Kᵀ) and as an MN-major one
// (its rows are the product's K: V in P·V).
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include <cstdint>

#include "hopper.cuh"

namespace repro {

template <int HD>
struct TileGeo {
  static constexpr int ROWB = HD * 2 < 128 ? HD * 2 : 128;
  static constexpr int BC = ROWB / 2;
  static constexpr int NCB = HD / BC;
  static constexpr int KPR = ROWB / 32;  // 16-wide k steps per row
  static constexpr int LAYOUT = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;  // wgmma descriptor
  static constexpr int TILE64 = NCB * 64 * ROWB;  // bytes of a 64-row tile
  static_assert(HD % BC == 0 && (64 * ROWB) % 1024 == 0, "geometry");
};

// K-major operand (a tile of `rows` rows), k step kk of 16 columns: column
// block kk / KPR, 32 bytes into its swizzled rows per step within it
template <int HD>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t base, int rows, int kk) {
  using G = TileGeo<HD>;
  const uint32_t a = base + (kk / G::KPR) * rows * G::ROWB + (kk % G::KPR) * 32;
  return make_desc(a, 16, 8 * G::ROWB, G::LAYOUT);
}

// MN-major operand: column block cb of a tile of `rows` rows, rows
// [16 kk, 16 kk + 16) as the product's k step
template <int HD>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t base, int rows, int cb, int kk) {
  using G = TileGeo<HD>;
  const uint32_t a = base + cb * rows * G::ROWB + kk * 16 * G::ROWB;
  return make_desc(a, rows * G::ROWB, 8 * G::ROWB, G::LAYOUT);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// a completion that never comes traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

// TMA: box of a 4-D map at coordinates (c0 innermost) into shared memory
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- host ----------------------------------------------------------------

template <int HD>
inline CUtensorMapSwizzle tile_swizzle() {
  return TileGeo<HD>::ROWB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : TileGeo<HD>::ROWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                   : CU_TENSOR_MAP_SWIZZLE_32B;
}

// cuTensorMapEncodeTiled from the driver the process already loaded
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// 4-D map over a contiguous bf16 [batch, rows, heads, hd] tensor; a box is
// `box_rows` rows x `box_cols` columns of one head of one batch row
inline bool make_map(CUtensorMap* map, const void* ptr, int batch, int rows, int heads, int hd,
                     int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t e = sizeof(__nv_bfloat16);
  cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)rows,
                        (cuuint64_t)batch};
  cuuint64_t strides[3] = {hd * e, (cuuint64_t)heads * hd * e,
                           (cuuint64_t)rows * heads * hd * e};
  cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)box_rows, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the map of a 64-row tile of one head of [batch, rows, heads, HD] bf16
template <int HD>
inline bool tile_map(CUtensorMap* map, const void* ptr, int batch, int rows, int heads) {
  return make_map(map, ptr, batch, rows, heads, HD, 64, TileGeo<HD>::BC, tile_swizzle<HD>());
}

}  // namespace repro
