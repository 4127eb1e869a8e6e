// K2: one 2D synthesis level per image, out = Sr . [[aa, ad], [da, dd]] . Sc^T,
// the full (2h - L + 2) x (2w - L + 2) reconstruction, row-major.
//
// Replaces the TPU kernel wam_tpu/wavelets/matmul.py::_fused_synth_kernel
// (launched by _synth_pallas_forward, exposed as idwt2_pallas). Sr and Sc
// are the stacked [S_lo | S_hi] synthesis operators ((2h - L + 2) x 2h and
// (2w - L + 2) x 2w); the subbands are float32 or bfloat16 (upcast on load,
// as the TPU kernel upcasts in VMEM) and the pixels are float32. The
// backward is K1 (dwt2.cu) with M1 = Sr^T and M2 = Sc, as on the TPU.
//
// The subband merge is part of the kernel, as it is part of the TPU
// kernel's body: X[n] is the 2h x 2w block matrix, and QuadrantSource
// stages its row q straight from the two subbands that hold it, so the
// merged matrix never exists in device memory.
//
// Bound on an H100: Sr and Sc have at most L nonzeros per row (8 for db4),
// so at 288 x 288 (h = w = 147) a level needs ~2.7 MFLOP per image against
// 680 KB moved (subbands read once, pixels written once): HBM bytes bind
// (chip_smoke.py counts the bound from the operators' nonzeros). The dense
// product this kernel did before (mm2.cuh) cost 98.6 MFLOP per image and
// was bound by the f32 CUDA-core rate, 29x off the bytes bound.
// Design (band2.cuh): the product skips the operators' zeros. Output rows
// 2m and 2m + 1 read the same L/2 rows of each subband half, so a tile of
// such row pairs stages those merged rows once and each staged value feeds
// both; the column pass pairs output columns 2m and 2m + 1 the same way.
// The subbands are read from HBM about once, the pixels written once.

#include "band2.cuh"

namespace wam_synth2 {

// Row q of the 2h x 2w block matrix [[aa, ad], [da, dd]]: row q mod h of
// subbands 0 | 1 (q < h) or 2 | 3 (q >= h), side by side in the stage.
template <typename TX>
struct QuadrantSource {
  const TX* sub;
  int h, w;
  __device__ __forceinline__ void stage_row(float* dst, int n, int q, int lane) const {
    const int bottom = q >= h;
    const TX* left = sub + (((size_t)n * 4 + 2 * bottom) * h + (q - bottom * h)) * w;
    const TX* right = left + (size_t)h * w;
    for (int c = lane; c < w; c += 32) {
      band::stage_value(dst + c, left + c);
      band::stage_value(dst + w + c, right + c);
    }
  }
};

template <typename TX>
int synth2(const void* sub, void* out, const void* plan, int kc, int N, int Q, int S, int P,
           int T, int ntiles, int rt, int sm, int k, int tp, int odd_off, int ts_stride,
           int stages, int cols_shared, void* stream) {
  return band::launch(QuadrantSource<TX>{static_cast<const TX*>(sub), Q / 2, S / 2},
                      band::RowMajorStore{static_cast<float*>(out), P, T}, plan, kc, N, S,
                      ntiles, rt, sm, k, tp, odd_off, ts_stride, stages, cols_shared, stream);
}

}  // namespace wam_synth2

// sub: (N, 4, Q/2, S/2) in (aa, ad, da, dd) order; plan: the band plan of
// M1 = Sr (P rows) and M2 = Sc^T (T columns); out: (N, P, T) float32.
extern "C" int wam_synth2_f32(const void* sub, void* out, const void* plan, int kc, int N,
                              int Q, int S, int P, int T, int ntiles, int rt, int sm, int k,
                              int tp, int odd_off, int ts_stride, int stages, int cols_shared,
                              void* stream) {
  return wam_synth2::synth2<float>(sub, out, plan, kc, N, Q, S, P, T, ntiles, rt, sm, k, tp,
                                   odd_off, ts_stride, stages, cols_shared, stream);
}

extern "C" int wam_synth2_bf16(const void* sub, void* out, const void* plan, int kc, int N,
                               int Q, int S, int P, int T, int ntiles, int rt, int sm, int k,
                               int tp, int odd_off, int ts_stride, int stages, int cols_shared,
                               void* stream) {
  return wam_synth2::synth2<__nv_bfloat16>(sub, out, plan, kc, N, Q, S, P, T, ntiles, rt, sm,
                                           k, tp, odd_off, ts_stride, stages, cols_shared,
                                           stream);
}
