// K2: one 2D synthesis level per image, out = Sr . [[aa, ad], [da, dd]] . Sc^T,
// the full (2h - L + 2) x (2w - L + 2) reconstruction, row-major.
//
// Replaces the TPU kernel wam_tpu/wavelets/matmul.py::_fused_synth_kernel
// (launched by _synth_pallas_forward, exposed as idwt2_pallas). Sr and Sc
// are the stacked [S_lo | S_hi] synthesis operators ((2h - L + 2) x 2h and
// (2w - L + 2) x 2w); the subbands are float32 or bfloat16 (upcast on load,
// as the TPU kernel upcasts in VMEM) and the pixels are float32. The
// backward is K1 (dwt2.cu) with A^T = Sr and B^T = Sc, as on the TPU.
//
// The subband merge is part of the kernel, as it is part of the TPU
// kernel's body: X[n] is the 2h x 2w block matrix, read straight from the
// (N, 4, h, w) subbands by QuadrantSource, so the merged matrix never
// exists in device memory.
//
// Bound on an H100: Sr and Sc have at most 8 nonzeros per column (db4), so
// at 288 x 288 (h = w = 147) a level needs ~2.7 MFLOP per image against
// 680 KB moved (subbands read once, pixels written once): HBM bytes bind
// (chip_smoke.py counts the bound from the operators' nonzeros). This
// kernel does the dense 2.P.2w.(2h + Q) FLOP (98.6 MFLOP per image), so as
// written the f32 CUDA-core rate bounds it (mm2.cuh).
// Design (mm2.cuh): a block owns 16 output rows of one image, keeps the
// 16 x 2w strip Sr[rows] . X in shared memory (18.8 KB at w = 147) and
// streams Sc^T against it, so each subband value and each Sc^T value is
// read once per 16 rows and the intermediate stays on chip.

#include "mm2.cuh"

namespace wam_synth2 {

// Column s of the block matrix as an offset from its row in the left-hand
// subband: the right-hand subband (s >= w) starts h * w elements later and
// its column s - w, so its offset is s + w * (h - 1).
struct QuadrantCols {
  int w, jump;
  __device__ __forceinline__ int operator()(int col) const { return col >= w ? col + jump : col; }
};

// X[n][q][s] of the 2h x 2w block matrix [[aa, ad], [da, dd]], read from
// sub[n][2 * (q >= h) + (s >= w)][q mod h][s mod w]: a chunk of rows is split
// at row h; within each half, rows are w elements apart and QuadrantCols
// places the columns (consecutive s stay consecutive addresses in a subband).
template <typename TX>
struct QuadrantSource {
  const TX* sub;
  int h, w;
  __device__ __forceinline__ void accumulate(float (&acc)[wam::kRows][wam::kCols],
                                             const float* L, int n, int q0, int kc,
                                             int c0) const {
    const TX* img = sub + (size_t)n * 4 * h * w;
    const QuadrantCols cols{w, w * (h - 1)};
    const int k_top = max(0, min(kc, h - q0));  // rows of the chunk in the top half
    if (k_top > 0)  // aa | ad, from row q0
      wam::accumulate(acc, L, img + (size_t)q0 * w, (size_t)w, k_top, c0, 2 * w, cols);
    if (kc > k_top)  // da | dd, from row q0 + k_top - h of subband 2
      wam::accumulate(acc, L + k_top * wam::kRows, img + (size_t)(h + q0 + k_top) * w,
                      (size_t)w, kc - k_top, c0, 2 * w, cols);
  }
};

template <typename TX>
static int synth2(const void* sub, const void* m1t, const void* m2, void* out, int N,
                  int P, int Q, int S, int T, void* stream) {
  return wam::launch(QuadrantSource<TX>{static_cast<const TX*>(sub), Q / 2, S / 2}, m1t, m2,
                     wam::RowMajorStore{static_cast<float*>(out), P, T}, N, P, Q, S, T,
                     stream);
}

}  // namespace wam_synth2

// sub: (N, 4, Q/2, S/2) in (aa, ad, da, dd) order; m1t = Sr^T: (Q = 2h, P);
// m2 = Sc^T: (S = 2w, T); out: (N, P, T) float32.
extern "C" int wam_synth2_f32(const void* sub, const void* m1t, const void* m2, void* out,
                              int N, int P, int Q, int S, int T, void* stream) {
  return wam_synth2::synth2<float>(sub, m1t, m2, out, N, P, Q, S, T, stream);
}

extern "C" int wam_synth2_bf16(const void* sub, const void* m1t, const void* m2, void* out,
                               int N, int P, int Q, int S, int T, void* stream) {
  return wam_synth2::synth2<__nv_bfloat16>(sub, m1t, m2, out, N, P, Q, S, T, stream);
}
