// K1: one 2D analysis level per image, [[aa, ad], [da, dd]] = A . X . B^T,
// written straight into the (N, 4, h', w') subband layout.
//
// Replaces the TPU kernel wam_tpu/wavelets/matmul.py::_fused_kernel (launched
// by _pallas_forward, exposed as dwt2_pallas). A = [A_lo; A_hi] (2h' x H)
// and B^T (W x 2w') are the banded analysis operators with the boundary mode
// folded in; X is float32 or bfloat16 (upcast on load, as the TPU kernel
// upcasts in VMEM) and the coefficients are float32.
//
// Bound on an H100: A and B^T have at most 8 nonzeros per row (db4), so a
// level needs 1.65 MFLOP per image at 224 x 224 against 412 KB moved: HBM
// bytes bind (chip_smoke.py counts the bound from the operators' nonzeros).
// This kernel does the dense 2.2h'.W.(H + 2w') FLOP (46.8 MFLOP per image),
// so as written the f32 CUDA-core rate bounds it (mm2.cuh). The quadrant
// split is fused into the store: the (2h' x 2w') product never exists in
// device memory.
// Design (mm2.cuh): a block owns 16 output rows of one image, keeps the
// 16 x W strip A[rows] . X in shared memory and streams B^T against it, so
// X and B^T are each read once per 16 rows and the intermediate stays on
// chip.

#include "mm2.cuh"

namespace wam_dwt2 {

struct QuadrantStore {
  float* out;
  int h, w;  // subband sides: P = 2h, T = 2w
  __device__ __forceinline__ void operator()(int n, int p, int t, float v) const {
    const int qr = p >= h, qc = t >= w;
    out[(((size_t)n * 4 + 2 * qr + qc) * h + (p - qr * h)) * w + (t - qc * w)] = v;
  }
};

}  // namespace wam_dwt2

// x: (N, Q=H, S=W); m1t = A^T: (H, P=2h'); m2 = B^T: (W, T=2w');
// out: (N, 4, h', w') float32.
// Also the backward of K2 (synth2.cu): with A^T = Sr and B^T = Sc it computes
// the quadrant split of Sr^T . g . Sc, as _synth_bwd does on the TPU.
template <typename TX>
static int dwt2(const void* x, const void* m1t, const void* m2, void* out, int N, int P,
                int Q, int S, int T, void* stream) {
  return wam::launch(wam::DenseSource<TX>{static_cast<const TX*>(x), Q, S}, m1t, m2,
                     wam_dwt2::QuadrantStore{static_cast<float*>(out), P / 2, T / 2},
                     N, P, Q, S, T, stream);
}

extern "C" int wam_dwt2_f32(const void* x, const void* m1t, const void* m2, void* out,
                            int N, int P, int Q, int S, int T, void* stream) {
  return dwt2<float>(x, m1t, m2, out, N, P, Q, S, T, stream);
}

extern "C" int wam_dwt2_bf16(const void* x, const void* m1t, const void* m2, void* out,
                             int N, int P, int Q, int S, int T, void* stream) {
  return dwt2<__nv_bfloat16>(x, m1t, m2, out, N, P, Q, S, T, stream);
}
