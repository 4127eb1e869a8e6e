// K3: the level-collapsed 2D synthesis, out[n] = R . Y[n] . C^T, and (with
// the operators swapped) its adjoint R^T . g[n] . C.
//
// Replaces the TPU kernel wam_tpu/wavelets/matmul.py::_pair_kernel
// (launched by _pair_forward, exposed as waverec2_collapsed). R and C are
// the host-composed collapsed synthesis operators; Y is the block-diagonal
// coefficient matrix of the collapsed levels, float32.
//
// Bound on an H100: at 224 x 224 db4 J=3, Y is 420 x 420 (31% nonzero, one
// block per level on its diagonal) and R is 224 x 420 (7.5% nonzero), so
// the forward needs 4.6 MFLOP and the adjoint 9.1 MFLOP per image against
// 906 KB moved: HBM bytes bind. This kernel does the dense 121 MFLOP per
// image, so as written the f32 CUDA-core rate bounds it (mm2.cuh); it does
// not skip the zeros yet.
// Design (mm2.cuh): a block owns 16 output rows of one image, keeps the
// 16 x 420 strip R[rows] . Y in shared memory and streams C^T against it;
// the adjoint is the same launch with R^T -> R and C^T -> C.

#include "mm2.cuh"

// y: (N, Q, S) float32; m1t: (Q, P) = M1^T; m2: (S, T); out: (N, P, T).
// Forward: m1t = R^T, m2 = C^T. Backward: m1t = R, m2 = C.
extern "C" int wam_pair_f32(const void* y, const void* m1t, const void* m2, void* out,
                            int N, int P, int Q, int S, int T, void* stream) {
  return wam::launch(wam::DenseSource<float>{static_cast<const float*>(y), Q, S}, m1t, m2,
                     wam::RowMajorStore{static_cast<float*>(out), P, T}, N, P, Q, S, T, stream);
}
