// K3's body (pair.cu): the level-collapsed 2D synthesis out[n] = R . Y[n] . C^T
// as banded per-level products that read the coefficient leaves, and its
// adjoint, which writes each leaf's gradient.
//
// R = [R_J | ... | R_1] (F_r x 2 sum r_l) and C = [C_J | ... | C_1]
// (F_c x 2 sum c_l) are the host-composed collapsed synthesis operators and
// Y = diag(Y_J, ..., Y_1) with Y_l = [[aa or 0, V_l], [H_l, D_l]] (aa only at
// the coarsest level J), so
//
//   forward:   out = sum_l R_l . Y_l . C_l^T
//   backward:  [[daa, dV_l], [dH_l, dD_l]] = R_l^T . g . C_l
//
// Each level is a band product in band2.cuh's plan layout (tsrc, then each
// tile's trow, tidx, tw, then ccol, cidx, cw), one plan per level and
// direction, end to end in one blob (wam_tpu_torch/wavelets/matmul.py,
// `pair_band`). As in band2.cuh, a persistent grid walks the work items in
// order, the next item's source rows are copied with 4-byte cp.async into a
// second stage while the current one computes (or, for larger tiles, one
// stage and a second block on the SM), output rows and columns come
// in pairs that share their taps, and everything accumulates in float32 with
// FMAs on the CUDA cores. What differs:
//
// - Forward, one launch. A work item is one image and one tile of output row
//   pairs (2m, 2m + 1). It walks the levels coarsest first: it stages the
//   rows of Y_l that the tile's taps name straight from the leaves (row
//   k < r_l is [aa, or zeros below the coarsest level | V_l], row k >= r_l is
//   [H_l | D_l]), runs the row pass into the strip and the column pass with
//   C_l's taps. Every level shares the row tiles and the column pairs, so a
//   thread owns the same outputs at every level: it keeps their sums in
//   registers across the levels and stores them once. Y never exists in
//   device memory.
// - Backward, one launch. A work item is (image, level, tile of row pairs
//   (i, r_l + i)), its own band product on g. With the columns paired
//   (j, c_l + j) too, a pair's four outputs are element (i, j) of aa, V, H
//   and D (K1's quadrant split), written straight into the leaves'
//   gradients: dY never exists. C_l's column taps step by 2^depth columns of
//   g (2, 4, 8 at the finest, middle and coarsest of three levels), so the
//   strip groups its columns by that step (`fold_log2`, `fstride`) and a
//   warp's reads of one tap fall on 32 banks. Taps run up to 50 at the
//   coarsest level: 16 in registers, the rest in a loop.
// - The leaves are (N, rows, cols) float32 with contiguous columns, read or
//   written through their pointers and strides (Leaf), so views of K1's
//   (N, 4, h, w) output are read in place. They come by value in the launch
//   arguments, with the plans' shapes; each level's fields are picked with
//   constant indices, so no kernel argument is copied to local memory.
#pragma once

#include "band2.cuh"

namespace collapsed {

constexpr int kMaxLevels = 8;
constexpr int kRowsPerThread = 16;  // forward: output rows a thread sums in registers

struct Leaf {
  float* ptr;    // element (n, i, j) at ptr[n * img + i * row + j]
  long long img;
  long long row;
};

// The approximation (coarsest level only), then each level's H, V, D,
// coarsest first (the order of waverec2's leaves), with the levels'
// coefficient sides r_l x c_l.
struct Leaves {
  Leaf leaf[1 + 3 * kMaxLevels];
  int rows[kMaxLevels], cols[kMaxLevels];
  int levels;
};

// One level's band plan: word offsets of its arrays in the blob and its
// shape (band2.cuh's Plan fields; s is the staged rows' width, fold_log2 and
// fstride the strip's column grouping).
struct LevelPlan {
  int tsrc, tdat, ccols, ntiles, rt, sm, k, kc, tp, s, fold_log2, fstride, ts_stride;
};

// The levels' plans and the block's shape: `stages` (2: the next work
// item's rows land while this one computes; 1: one stage, for larger tiles)
// of stage_words floats each, then the strip.
struct Plans {
  const int* blob;
  int levels, threads, stages, stage_words, strip_words;
  LevelPlan lv[kMaxLevels];
};

inline size_t smem_bytes(const Plans& pl) {
  return ((size_t)pl.stages * pl.stage_words + pl.strip_words) * sizeof(float);
}

template <typename T>
__device__ __forceinline__ T pick(const T (&arr)[kMaxLevels], int l) {
  T out = arr[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (i == l) out = arr[i];
  return out;
}

// Level l's H, V, D (and its aa: the approximation at level 0, else none).
__device__ __forceinline__ void level_leaves(const Leaves& src, int l, Leaf& aa, Leaf& hh,
                                             Leaf& vv, Leaf& dd) {
  aa = l == 0 ? src.leaf[0] : Leaf{nullptr, 0, 0};
  hh = src.leaf[1];
  vv = src.leaf[2];
  dd = src.leaf[3];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (i == l) {
      hh = src.leaf[1 + 3 * i];
      vv = src.leaf[2 + 3 * i];
      dd = src.leaf[3 + 3 * i];
    }
}

// Output columns as the plan numbers them (the epilogues here place them).
struct ColumnIndex {
  __device__ __forceinline__ size_t col(int t) const { return (size_t)t; }
};

// Row pass of one staged tile: T[2r + h][pos(c)] = sum_k tw[r][h][k] .
// stage[tidx[r][k]][c] for the tile's row pairs, c < s, where pos groups
// the columns by c mod 2^fold_log2. A warp takes a row pair, its lanes the
// columns; a tile of fewer row pairs than warps (the backward's coarsest
// level takes one) splits each pair's columns over `parts` warps.
template <int KC>
__device__ __forceinline__ void row_pass(const float* stage, const LevelPlan& lp, float* T) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int* trow = reinterpret_cast<const int*>(stage + (size_t)lp.sm * lp.s);
  const int* tidx = trow + 2 * lp.rt;
  const float* tw = reinterpret_cast<const float*>(tidx + lp.rt * lp.k);
  const int fmask = (1 << lp.fold_log2) - 1;
  const int parts = lp.rt >= nwarps ? 1 : min((lp.s + 31) >> 5, nwarps / lp.rt);
  for (int u = warp; u < lp.rt * parts; u += nwarps) {
    const int r = u / parts, part = u - r * parts;
    if (trow[2 * r] < 0) continue;  // the ragged end of the last tile
    const int* ti = tidx + r * lp.k;
    const float* twa = tw + 2 * r * lp.k;
    const float* twb = twa + lp.k;
    int off[KC];
    float wa[KC], wb[KC];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      off[kk] = ti[kk] * lp.s;
      wa[kk] = twa[kk];
      wb[kk] = twb[kk];
    }
    float* ta = T + (size_t)(2 * r) * lp.ts_stride;
    float* tb = ta + lp.ts_stride;
    for (int c = part * 32 + lane; c < lp.s; c += parts * 32) {
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float v = stage[off[kk] + c];
        a = fmaf(wa[kk], v, a);
        b = fmaf(wb[kk], v, b);
      }
#pragma unroll 4
      for (int kk = KC; kk < lp.k; ++kk) {  // taps past the first KC
        const float v = stage[ti[kk] * lp.s + c];
        a = fmaf(twa[kk], v, a);
        b = fmaf(twb[kk], v, b);
      }
      const int pc = (c & fmask) * lp.fstride + (c >> lp.fold_log2);
      ta[pc] = a;
      tb[pc] = b;
    }
  }
}

// Sums of one column pair against strip row `row`: a for its first column,
// b for its second.
template <int KC>
__device__ __forceinline__ void col_sums(const band::ColTaps<KC>& ct, const LevelPlan& lp,
                                         const float* row, float& a, float& b) {
  a = 0.f;
  b = 0.f;
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    const float v = row[ct.col[kk]];
    a = fmaf(ct.wa[kk], v, a);
    b = fmaf(ct.wb[kk], v, b);
  }
#pragma unroll 4
  for (int kk = KC; kk < lp.k; ++kk) {
    const float v = row[ct.ci[kk * lp.tp]];
    a = fmaf(ct.cwa[kk * lp.tp], v, a);
    b = fmaf(ct.cwa[(lp.k + kk) * lp.tp], v, b);
  }
}

// Forward column pass: this thread's column pair `cp` against strip rows
// g, g + groups, ..., added to its sums.
template <int KC>
__device__ __forceinline__ void col_accumulate(float (&acc)[kRowsPerThread][2], const int* cols,
                                               const LevelPlan& lp, int cp, int g, int groups,
                                               const float* T) {
  band::ColTaps<KC> ct;
  ct.load(cols, lp.tp, lp.k, cp, ColumnIndex{});
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int rho = g + i * groups;
    if (rho < 2 * lp.rt) {
      float a, b;
      col_sums<KC>(ct, lp, T + (size_t)rho * lp.ts_stride, a, b);
      acc[i][0] += a;
      acc[i][1] += b;
    }
  }
}

// Backward column pass of level l, stored into the leaves' gradients: row
// pair (i, r + i) and column pair (j, c + j) give element (i, j) of aa
// (coarsest level only) and V (top row), H and D (bottom row).
template <int KC>
__device__ __forceinline__ void col_store(const int* cols, const LevelPlan& lp, const float* T,
                                          const int* trow, int n, int r, Leaf aa, Leaf hh,
                                          Leaf vv, Leaf dd) {
  const int groups = max(1, (int)blockDim.x / lp.tp);
  for (int u = threadIdx.x; u < groups * lp.tp; u += blockDim.x) {
    band::ColTaps<KC> ct;
    ct.load(cols, lp.tp, lp.k, u % lp.tp, ColumnIndex{});
    const long long j = (long long)ct.ca;
    for (int rho = u / lp.tp; rho < 2 * lp.rt; rho += groups) {
      const int p = trow[rho];
      if (p < 0) continue;
      float a, b;
      col_sums<KC>(ct, lp, T + (size_t)rho * lp.ts_stride, a, b);
      const bool bottom = p >= r;
      const long long i = p - (bottom ? r : 0);
      const Leaf left = bottom ? hh : aa, right = bottom ? dd : vv;
      if (left.ptr) left.ptr[n * left.img + i * left.row + j] = a;
      right.ptr[n * right.img + i * right.row + j] = b;
    }
  }
}

#define COLLAPSED_BY_KC(kc, CALL) \
  switch (kc) {                   \
    case 2: CALL(2); break;       \
    case 4: CALL(4); break;       \
    case 8: CALL(8); break;       \
    default: CALL(16); break;     \
  }

__global__ void __launch_bounds__(band::kMaxThreads)
    forward_kernel(Leaves src, Plans pl, float* __restrict__ out, int N, int P, int T) {
  extern __shared__ __align__(16) float smem[];
  float* const strip = smem + pl.stages * pl.stage_words;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int L = pl.levels;
  const int ntiles = pl.lv[0].ntiles, tp = pl.lv[0].tp, rows2 = 2 * pl.lv[0].rt;
  const long long nwork = (long long)N * ntiles;
  // This thread's column pair and rows, the same at every level.
  const int groups = blockDim.x / tp, cp = threadIdx.x % tp, g = threadIdx.x / tp;
  const bool owner = g < groups;
  const int* ccol = pl.blob + pl.lv[0].ccols;
  const int ta = owner ? ccol[cp] : -1, tb = owner ? ccol[tp + cp] : -1;
  float acc[kRowsPerThread][2];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i][0] = acc[i][1] = 0.f;

  // Step `it` of this block is level it % L of work item work_of(it).
  auto work_of = [&](long long it) { return blockIdx.x + (it / L) * (long long)gridDim.x; };
  auto issue = [&](long long it, float* stage) {
    const long long work = work_of(it);
    const int l = (int)(it % L);
    const LevelPlan lp = pick(pl.lv, l);
    const int n = (int)(work / ntiles), j = (int)(work - (long long)n * ntiles);
    const int r = pick(src.rows, l), c = pick(src.cols, l);
    Leaf aa, hh, vv, dd;
    level_leaves(src, l, aa, hh, vv, dd);
    const int* tsrc = pl.blob + lp.tsrc + (size_t)j * lp.sm;
    for (int s = warp; s < lp.sm; s += nwarps) {
      const int q = __ldg(tsrc + s);
      if (q < 0) continue;
      float* dst = stage + (size_t)s * lp.s;
      const bool bottom = q >= r;
      const long long i = q - (bottom ? r : 0);
      const Leaf left = bottom ? hh : aa, right = bottom ? dd : vv;
      const float* lrow = left.ptr ? left.ptr + n * left.img + i * left.row : nullptr;
      const float* rrow = right.ptr + n * right.img + i * right.row;
      for (int col = lane; col < c; col += 32) {
        if (lrow)
          band::copy4(dst + col, lrow + col);
        else
          dst[col] = 0.f;
        band::copy4(dst + c + col, rrow + col);
      }
    }
    const int words = band::tile_words(lp.rt, lp.k);
    const int* from = pl.blob + lp.tdat + (size_t)j * words;
    float* to = stage + (size_t)lp.sm * lp.s;
    for (int e = threadIdx.x; e < words; e += blockDim.x) band::copy4(to + e, from + e);
  };

  if (pl.stages == 2 && work_of(0) < nwork) issue(0, smem);
  band::commit();
  for (long long it = 0; work_of(it) < nwork; ++it) {
    float* cur = smem;
    if (pl.stages == 2) {
      cur += (it & 1) * pl.stage_words;
      if (work_of(it + 1) < nwork) issue(it + 1, smem + ((it + 1) & 1) * pl.stage_words);
      band::commit();
      band::wait_pending<1>();  // every group but the newest is done: `cur` has landed
    } else {
      issue(it, cur);
      band::commit();
      band::wait_pending<0>();
    }
    __syncthreads();
    const int l = (int)(it % L);
    const LevelPlan lp = pick(pl.lv, l);
#define COLLAPSED_ROW(KC) row_pass<KC>(cur, lp, strip)
    COLLAPSED_BY_KC(lp.kc, COLLAPSED_ROW)
#undef COLLAPSED_ROW
    __syncthreads();
    if (owner) {
#define COLLAPSED_COL(KC) col_accumulate<KC>(acc, pl.blob + lp.ccols, lp, cp, g, groups, strip)
      COLLAPSED_BY_KC(lp.kc, COLLAPSED_COL)
#undef COLLAPSED_COL
    }
    if (l == L - 1) {  // the tile's last level: store its sums once
      const int n = (int)(work_of(it) / ntiles);
      const int* trow = reinterpret_cast<const int*>(cur + (size_t)lp.sm * lp.s);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int rho = g + i * groups;
        if (owner && rho < rows2) {
          const int p = trow[rho];
          if (p >= 0) {
            float* o = out + ((size_t)n * P + p) * T;
            o[ta] = acc[i][0];
            if (tb >= 0) o[tb] = acc[i][1];
          }
        }
        acc[i][0] = acc[i][1] = 0.f;
      }
    }
    __syncthreads();  // the strip and this stage are rewritten in the next round
  }
}

__global__ void __launch_bounds__(band::kMaxThreads)
    backward_kernel(const float* __restrict__ gin, Leaves grads, Plans pl, int N, int P, int T) {
  extern __shared__ __align__(16) float smem[];
  float* const strip = smem + pl.stages * pl.stage_words;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  int per_image = 0;
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i)
    if (i < pl.levels) per_image += pl.lv[i].ntiles;
  const long long nwork = (long long)N * per_image;

  // Work item `work` is tile j of level l of image n, levels coarsest first.
  auto locate = [&](long long work, int& n, int& l, int& j) {
    n = (int)(work / per_image);
    int rem = (int)(work - (long long)n * per_image);
    l = 0;
#pragma unroll
    for (int i = 0; i < kMaxLevels - 1; ++i)
      if (l == i && i + 1 < pl.levels && rem >= pl.lv[i].ntiles) {
        rem -= pl.lv[i].ntiles;
        l = i + 1;
      }
    j = rem;
  };
  auto issue = [&](long long work, float* stage) {
    int n, l, j;
    locate(work, n, l, j);
    const LevelPlan lp = pick(pl.lv, l);
    const int* tsrc = pl.blob + lp.tsrc + (size_t)j * lp.sm;
    for (int s = warp; s < lp.sm; s += nwarps) {
      const int q = __ldg(tsrc + s);
      if (q < 0) continue;
      const float* row = gin + ((size_t)n * P + q) * T;
      float* dst = stage + (size_t)s * lp.s;
      for (int col = lane; col < T; col += 32) band::copy4(dst + col, row + col);
    }
    const int words = band::tile_words(lp.rt, lp.k);
    const int* from = pl.blob + lp.tdat + (size_t)j * words;
    float* to = stage + (size_t)lp.sm * lp.s;
    for (int e = threadIdx.x; e < words; e += blockDim.x) band::copy4(to + e, from + e);
  };

  long long work = blockIdx.x;
  if (pl.stages == 2 && work < nwork) issue(work, smem);
  band::commit();
  for (int it = 0; work < nwork; ++it, work += gridDim.x) {
    float* cur = smem;
    if (pl.stages == 2) {
      cur += (it & 1) * pl.stage_words;
      if (work + gridDim.x < nwork) issue(work + gridDim.x, smem + ((it + 1) & 1) * pl.stage_words);
      band::commit();
      band::wait_pending<1>();
    } else {
      issue(work, cur);
      band::commit();
      band::wait_pending<0>();
    }
    __syncthreads();
    int n, l, j;
    locate(work, n, l, j);
    const LevelPlan lp = pick(pl.lv, l);
#define COLLAPSED_ROW(KC) row_pass<KC>(cur, lp, strip)
    COLLAPSED_BY_KC(lp.kc, COLLAPSED_ROW)
#undef COLLAPSED_ROW
    __syncthreads();
    const int* trow = reinterpret_cast<const int*>(cur + (size_t)lp.sm * lp.s);
    Leaf aa, hh, vv, dd;
    level_leaves(grads, l, aa, hh, vv, dd);
    const int r = pick(grads.rows, l);
#define COLLAPSED_COL(KC) col_store<KC>(pl.blob + lp.ccols, lp, strip, trow, n, r, aa, hh, vv, dd)
    COLLAPSED_BY_KC(lp.kc, COLLAPSED_COL)
#undef COLLAPSED_COL
    __syncthreads();
  }
}

#undef COLLAPSED_BY_KC

// As many blocks of `kernel` as fit on the SMs at (threads, smem), at most
// nwork; the dynamic shared-memory cap is raised to the device's opt-in
// maximum on the first launch there (per kernel: each instantiation keeps
// its own record).
template <typename Kernel>
int grid_size(Kernel kernel, int threads, size_t smem, long long nwork, int* grid) {
  static std::atomic<bool> configured[band::kMaxDevices];
  static int sm_count[band::kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  if (device >= band::kMaxDevices || !configured[device].load(std::memory_order_acquire)) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    if (device < band::kMaxDevices) {
      sm_count[device] = sms;
      configured[device].store(true, std::memory_order_release);
    }
  } else {
    sms = sm_count[device];
  }
  int per_sm = 0;
  const int occ = band::blocks_per_sm(kernel, device, threads, smem, &per_sm);
  if (occ != 0) return occ;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long most = (long long)per_sm * sms;
  *grid = (int)(nwork < most ? nwork : most);
  return 0;
}

// Launches on `stream`, on the calling thread's current device, and return
// cudaGetLastError() (0 on success). The caller sets the device, allocates
// the outputs and checks shapes and the shared-memory size; N >= 1.
inline int launch_forward(const Leaves& src, const Plans& pl, float* out, int N, int P, int T,
                          void* stream) {
  const size_t smem = smem_bytes(pl);
  int grid = 0;
  const int err = grid_size(forward_kernel, pl.threads, smem, (long long)N * pl.lv[0].ntiles,
                            &grid);
  if (err != 0) return err;
  forward_kernel<<<grid, pl.threads, smem, (cudaStream_t)stream>>>(src, pl, out, N, P, T);
  return (int)cudaGetLastError();
}

inline int launch_backward(const float* g, const Leaves& grads, const Plans& pl, int N, int P,
                           int T, void* stream) {
  long long per_image = 0;
  for (int i = 0; i < pl.levels; ++i) per_image += pl.lv[i].ntiles;
  const size_t smem = smem_bytes(pl);
  int grid = 0;
  const int err = grid_size(backward_kernel, pl.threads, smem, N * per_image, &grid);
  if (err != 0) return err;
  backward_kernel<<<grid, pl.threads, smem, (cudaStream_t)stream>>>(g, grads, pl, N, P, T);
  return (int)cudaGetLastError();
}

}  // namespace collapsed
