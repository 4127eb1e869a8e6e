// K3: the level-collapsed 2D synthesis, out[n] = R . Y[n] . C^T, and its
// adjoint, which writes the gradient of every coefficient leaf.
//
// Replaces the TPU kernel wam_tpu/wavelets/matmul.py::_pair_kernel
// (launched by _pair_forward, exposed as waverec2_collapsed), with the
// assembly of Y before it and, in the backward, _pair_bwd and the slices
// of dY after it. R and C are the host-composed collapsed synthesis
// operators; Y is the block-diagonal matrix of the collapsed levels'
// coefficients, per level [[aa, V], [H, D]] with aa only at the coarsest.
// Here Y is never assembled: the kernel reads the leaves (cA and each
// level's H, V, D) where they lie, through their pointers and strides, and
// its adjoint writes their gradients. Leaves are float32; the wrapper
// (matmul.waverec2_collapsed) upcasts bf16 leaves first, as the assembly
// did, so both directions accumulate float32.
//
// Bound on an H100: at 224 x 224 db4 J=3 (sides 34/61/115, F = 224) the
// forward needs 2.3 M multiply-adds per image (R and C are banded per level
// block, Y is 31% nonzero), ~1.8 GFLOP per 384-image chunk, against the
// bytes it must move: the leaves (Y's nonzeros, 221.8 KB an image) read
// once and the output (200.7 KB) written once, 162 MB a chunk, ~0.05 ms
// at 3.35 TB/s against ~0.03 ms for the FLOP. The backward moves the same
// bytes the other way (g in, the leaves' gradients out). HBM bytes bind;
// the dense product this kernel did before (mm2.cuh) cost 60.6 M
// multiply-adds per image in the forward and was bound by the f32
// CUDA-core rate, ~22x off the bytes bound.
// Design (collapsed.cuh): since R = [R_J | ... | R_1] and Y is block
// diagonal, out = sum_l R_l . Y_l . C_l^T, each term a banded product of
// K2's shape. The forward stages the rows of Y_l that a tile of output
// rows names straight from the leaves, level after level, and sums the
// levels in registers; the backward computes each level's R_l^T . g . C_l
// as its own tiles and splits it into the leaves' gradients as K1 splits
// its quadrants. Neither Y nor dY (271 MB each per flagship chunk) exists
// in device memory; g and the leaves are read from HBM about once.

#include "collapsed.cuh"

// leaves: a collapsed::Leaves of (N, r_l, c_l) float32 inputs; plans: the
// forward collapsed::Plans; out: (N, P, T) float32.
extern "C" int wam_pair_fwd_f32(const void* leaves, const void* plans, void* out, int N, int P,
                                int T, void* stream) {
  return collapsed::launch_forward(*static_cast<const collapsed::Leaves*>(leaves),
                                   *static_cast<const collapsed::Plans*>(plans),
                                   static_cast<float*>(out), N, P, T, stream);
}

// g: (N, P, T) float32, contiguous; grads: a collapsed::Leaves of
// contiguous (N, r_l, c_l) float32 outputs; plans: the backward Plans.
extern "C" int wam_pair_bwd_f32(const void* g, const void* grads, const void* plans, int N, int P,
                                int T, void* stream) {
  return collapsed::launch_backward(static_cast<const float*>(g),
                                    *static_cast<const collapsed::Leaves*>(grads),
                                    *static_cast<const collapsed::Plans*>(plans), N, P, T, stream);
}
