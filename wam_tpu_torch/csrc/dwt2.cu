// K1: one 2D analysis level per image, [[aa, ad], [da, dd]] = A . X . B^T,
// written straight into the (N, 4, h', w') subband layout.
//
// Replaces the TPU kernel wam_tpu/wavelets/matmul.py::_fused_kernel (launched
// by _pallas_forward, exposed as dwt2_pallas). A = [A_lo; A_hi] (2h' x H)
// and B^T (W x 2w') are the banded analysis operators with the boundary mode
// folded in; X is float32 or bfloat16 (upcast on load, as the TPU kernel
// upcasts in VMEM) and the coefficients are float32.
//
// Bound on an H100: A and B^T have at most L nonzeros per row (L = the
// filter length, 8 for db4), so a level needs 1.65 MFLOP per image at
// 224 x 224 against 412 KB moved: HBM bytes bind (chip_smoke.py counts the
// bound from the operators' nonzeros). The dense product this kernel did
// before (mm2.cuh) cost 46.8 MFLOP per image and was bound by the f32
// CUDA-core rate, 29-36x off the bytes bound.
// Design (band2.cuh): the product skips the operators' zeros. A block
// stages the source rows that a tile of row pairs (i, h' + i) names, which
// the lo and hi rows read alike, so each staged value feeds both; the row
// pass keeps the 2rt x W strip A[rows] . X in shared memory and the column
// pass reads B's taps for the column pairs (j, w' + j) against it. The
// quadrant split is fused into the store: the (2h' x 2w') product never
// exists in device memory. X is read from HBM about once, the subbands are
// written once.

#include "band2.cuh"

namespace wam_dwt2 {

// Output (n, p, t) of the 2h x 2w product at subband 2 (p >= h) + (t >= w),
// row p mod h, column t mod w: a row offset plus a column offset
// (band2.cuh's epilogue).
struct QuadrantStore {
  float* out;
  int h, w;  // subband sides: P = 2h, T = 2w
  __device__ __forceinline__ size_t row(int n, int p) const {
    const int qr = p >= h;
    return (((size_t)n * 4 + 2 * qr) * h + (p - qr * h)) * w;
  }
  __device__ __forceinline__ size_t col(int t) const {
    const int qc = t >= w;
    return (size_t)qc * h * w + (t - qc * w);
  }
};

// x: (N, Q=H, S=W); plan: the band plan of M1 = A (P = 2h' rows) and
// M2 = B^T (T = 2w' columns); out: (N, 4, h', w') float32.
// Also the backward of K2 (synth2.cu): with M1 = Sr^T and M2 = Sc it
// computes the quadrant split of Sr^T . g . Sc, as _synth_bwd does on the
// TPU.
template <typename TX>
int dwt2(const void* x, void* out, const void* plan, int kc, int N, int Q, int S, int P,
         int T, int ntiles, int rt, int sm, int k, int tp, int odd_off, int ts_stride,
         int stages, int cols_shared, void* stream) {
  return band::launch(band::DenseSource<TX>{static_cast<const TX*>(x), Q, S},
                      QuadrantStore{static_cast<float*>(out), P / 2, T / 2}, plan, kc, N, S,
                      ntiles, rt, sm, k, tp, odd_off, ts_stride, stages, cols_shared, stream);
}

}  // namespace wam_dwt2

extern "C" int wam_dwt2_f32(const void* x, void* out, const void* plan, int kc, int N, int Q,
                            int S, int P, int T, int ntiles, int rt, int sm, int k, int tp,
                            int odd_off, int ts_stride, int stages, int cols_shared,
                            void* stream) {
  return wam_dwt2::dwt2<float>(x, out, plan, kc, N, Q, S, P, T, ntiles, rt, sm, k, tp,
                               odd_off, ts_stride, stages, cols_shared, stream);
}

extern "C" int wam_dwt2_bf16(const void* x, void* out, const void* plan, int kc, int N, int Q,
                             int S, int P, int T, int ntiles, int rt, int sm, int k, int tp,
                             int odd_off, int ts_stride, int stages, int cols_shared,
                             void* stream) {
  return wam_dwt2::dwt2<__nv_bfloat16>(x, out, plan, kc, N, Q, S, P, T, ntiles, rt, sm, k, tp,
                                       odd_off, ts_stride, stages, cols_shared, stream);
}
