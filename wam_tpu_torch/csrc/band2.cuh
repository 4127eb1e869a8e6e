// Banded two-sided batched product, out[n] = M1 . X[n] . M2, the shared
// body of K1 (dwt2.cu: one analysis level) and K2 (synth2.cu: one synthesis
// level). K3 (pair.cu) stays on the dense loop of mm2.cuh.
//
// Shapes: M1 is P x Q with at most K nonzeros in each row, X[n] is Q x S,
// M2 is S x T with at most K nonzeros in each column (K <= the filter
// length: 8 for db4, 16 for db8). The operators come as a host-built plan
// (wam_tpu_torch/wavelets/matmul.py, `_band_plan_np`), one int32 blob:
//
//   tsrc [ntiles][sm]        source rows of X staged by each row tile (-1: none)
//   tdat [ntiles][tile_words] each tile's row pairs, staged with its rows:
//     trow [rt][2]           the two output rows of each row pair (-1: none)
//     tidx [rt][k]           the pair's taps, as slots of the tile's staged rows
//     tw   [rt][2][k]        the taps' weights for the pair's first and second row
//   ccol [2][tp]             the two output columns of each column pair (-1: none)
//   cidx [k][tp]             the pair's taps, as columns of the T strip
//   cw   [2][k][tp]          their weights for the pair's first and second column
// (the column pairs' arrays pair-minor, so a warp's lanes read consecutive
// words of them). A block copies the column pairs' arrays into shared
// memory when they fit (`cols_shared`, every side the paths use) and reads
// them from device memory otherwise (sides in the thousands).
//
// Output rows (and columns) come in pairs that read the same taps: K1's lo
// and hi rows i and h' + i, K2's output rows 2m and 2m + 1. So each value
// read from shared memory feeds two FMAs. Padded taps carry weight 0 and
// point at a slot or column that always holds finite data.
//
// What bounds it on an H100: after the zeros are skipped an output costs
// 2 K FMAs, about 4 FLOP per byte moved, far below the f32 ridge (~20 FLOP
// per byte at 67 TFLOP/s and 3.35 TB/s), so HBM bytes bind. The design reads
// each input byte from HBM about once and writes each output byte once:
//
// - A persistent grid (as many blocks as fit on the SMs) walks the (image,
//   row tile) pairs in order, so neighbouring tiles, which share a few
//   source rows, run at the same time and the second read hits L2.
// - Row pass: a tile's source rows are staged in shared memory, then each
//   warp takes a row pair and its lanes the columns:
//   T[p, c] = sum_k w1[p, k] . X[tidx[p, k], c], kept in shared memory.
// - Column pass: each thread takes a column pair and walks the strip's rows:
//   out[p, t] = sum_k w2[t, k] . T[p, cidx[t, k]], stored through the
//   caller's epilogue (quadrant split for K1, row-major for K2).
// - Copies overlap the arithmetic: the next tile's rows, with its row
//   pairs' taps (`tdat`), are copied with cp.async into a second stage while
//   the current tile computes (two stages; one when two do not fit), and
//   several blocks share an SM. The source-row numbers of the tile after
//   that are loaded into registers meanwhile (one per lane, handed round
//   with shuffles), and the column pairs' taps are copied into shared
//   memory once per block (when they fit), so no load from the plan in
//   device memory stalls a tile.
// - Shared memory is sized to the real column count S, not to a fixed
//   number of slots; the thread count to the column pairs.
// - Alignment: the copies are cp.async of 4 bytes, the one width every f32
//   row start meets at every level (odd widths such as 147, 115, 77 or 61
//   break 16-byte alignment, and with it TMA and vector loads). A bf16 row
//   of odd width starts on a 2-byte boundary, which no cp.async size takes,
//   so bf16 is loaded synchronously and upcast on its way into the stage
//   (float in shared memory for both types; the main path runs f32).
// - K1's analysis taps step by 2 columns per output column, so the strip
//   keeps its even columns first and its odd columns from `odd_off` on
//   (odd_off = 16 mod 32): a warp's reads of one tap then fall on
//   consecutive words, free of bank conflicts. K2's taps are already
//   consecutive (odd_off = 0: no permutation).
// Everything accumulates in float32 with FMAs on the CUDA cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <mutex>

namespace band {

constexpr int kMaxThreads = 512;
constexpr int kMaxDevices = 64;

// 4-byte asynchronous copy, global to shared (sm_80 and later).
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void stage_value(float* dst, const float* src) { copy4(dst, src); }

__device__ __forceinline__ void stage_value(float* dst, const __nv_bfloat16* src) {
  *dst = __bfloat162float(*src);
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// int32 words of one tile's row-pair data: trow, tidx, tw.
__host__ __device__ __forceinline__ int tile_words(int rt, int k) { return 2 * rt + 3 * rt * k; }
// int32 words of the column pairs' data: ccol, cidx, cw.
__host__ __device__ __forceinline__ int col_words(int tp, int k) { return tp * (2 + 3 * k); }

struct Plan {
  const int* tsrc;
  const int* tdat;
  const int* cols;  // ccol, cidx, cw
  int ntiles, rt, sm, k, tp, odd_off, ts_stride, stages, cols_shared;
};

inline Plan unpack(const void* blob, int ntiles, int rt, int sm, int k, int tp, int odd_off,
                   int ts_stride, int stages, int cols_shared) {
  const int* p = static_cast<const int*>(blob);
  Plan pl;
  pl.tsrc = p;
  p += (size_t)ntiles * sm;
  pl.tdat = p;
  p += (size_t)ntiles * tile_words(rt, k);
  pl.cols = p;
  pl.ntiles = ntiles;
  pl.rt = rt;
  pl.sm = sm;
  pl.k = k;
  pl.tp = tp;
  pl.odd_off = odd_off;
  pl.ts_stride = ts_stride;
  pl.stages = stages;
  pl.cols_shared = cols_shared;
  return pl;
}

// X[n] as a dense row-major (N, Q, S) tensor of float or bfloat16. A Source
// copies row q of image n into the S floats at `dst`, the warp's lanes on
// consecutive columns.
template <typename TX>
struct DenseSource {
  const TX* x;
  int Q, S;
  __device__ __forceinline__ void stage_row(float* dst, int n, int q, int lane) const {
    const TX* row = x + ((size_t)n * Q + q) * S;
    for (int c = lane; c < S; c += 32) stage_value(dst + c, row + c);
  }
};

// An epilogue places output (n, p, t) at out[row(n, p) + col(t)]: a column's
// offset is fixed for a thread, a row's is computed once for both columns of
// its pair. This one is row-major (N, P, T).
struct RowMajorStore {
  float* out;
  int P, T;
  __device__ __forceinline__ size_t row(int n, int p) const { return ((size_t)n * P + p) * T; }
  __device__ __forceinline__ size_t col(int t) const { return (size_t)t; }
};

// Shared memory: `stages` x (sm x S staged source rows and the tile's
// row-pair data), the 2 rt x ts_stride strip T, the column pairs' data
// (when `cols_shared`).
inline size_t smem_bytes(int S, int sm, int rt, int k, int tp, int ts_stride, int stages,
                         int cols_shared) {
  return ((size_t)stages * ((size_t)sm * S + tile_words(rt, k)) + (size_t)2 * rt * ts_stride +
          (cols_shared ? col_words(tp, k) : 0)) *
         sizeof(float);
}

// Threads of a block: about 256 column-pair lanes (G groups of tp, each
// group walking every G-th row of the strip), in whole warps.
inline int block_threads(int tp) {
  const int groups = tp >= 256 ? 1 : (256 + tp / 2) / tp;
  int threads = (groups * tp + 31) / 32 * 32;
  return threads < kMaxThreads ? threads : kMaxThreads;
}

// One column pair's taps, from the column data (`cols`, shared or device memory):
// output columns ta, tb (as the epilogue's offsets), the first KC taps in
// registers, the rest (filters over 16 long) read where they are.
template <int KC>
struct ColTaps {
  size_t ca, cb;
  bool has_b;
  int col[KC];
  float wa[KC], wb[KC];
  const int* ci;     // cidx[kk][cp] at ci[kk * tp]
  const float* cwa;  // cw[0][kk][cp] at cwa[kk * tp], cw[1][kk][cp] at cwa[(k + kk) * tp]

  template <typename Store>
  __device__ __forceinline__ void load(const int* cols, int tp, int k, int cp,
                                       const Store& store) {
    const int ta = cols[cp], tb = cols[tp + cp];
    ca = store.col(ta);
    has_b = tb >= 0;
    cb = has_b ? store.col(tb) : 0;
    ci = cols + 2 * tp + cp;
    cwa = reinterpret_cast<const float*>(cols + (2 + k) * tp + cp);
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      col[kk] = ci[kk * tp];
      wa[kk] = cwa[kk * tp];
      wb[kk] = cwa[(k + kk) * tp];
    }
  }
};

template <int KC, typename Source, typename Store>
__global__ void __launch_bounds__(kMaxThreads)
    band2_kernel(Source src, Plan pl, int N, int S, Store store) {
  extern __shared__ __align__(16) float smem[];
  const int rows_floats = pl.sm * S, tw_words = tile_words(pl.rt, pl.k);
  const int stage_floats = rows_floats + tw_words;
  float* const Ts = smem + pl.stages * stage_floats;
  int* const cols_smem = reinterpret_cast<int*>(Ts + 2 * pl.rt * pl.ts_stride);
  const int* const cols = pl.cols_shared ? cols_smem : pl.cols;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int nwork = N * pl.ntiles;

  // Lane l of warp w holds the source row of slot w + l * nwarps of the tile
  // of work item `work` (-1: none), ahead of the copy that needs it.
  auto slot_rows = [&](int work) -> int {
    const int s = warp + lane * nwarps;
    if (work >= nwork || s >= pl.sm) return -1;
    const int j = work - (work / pl.ntiles) * pl.ntiles;
    return __ldg(pl.tsrc + (size_t)j * pl.sm + s);
  };
  // Copy work item `work`'s source rows (numbers in `qreg`) and its row-pair
  // data into `stage`.
  auto issue = [&](int work, float* stage, int qreg) {
    const int n = work / pl.ntiles, j = work - n * pl.ntiles;
    for (int i = 0, s = warp; s < pl.sm; ++i, s += nwarps) {
      const int q = i < 32 ? __shfl_sync(0xffffffffu, qreg, i)
                           : __ldg(pl.tsrc + (size_t)j * pl.sm + s);
      if (q >= 0) src.stage_row(stage + (size_t)s * S, n, q, lane);
    }
    const int* from = pl.tdat + (size_t)j * tw_words;
    float* to = stage + rows_floats;
    for (int e = threadIdx.x; e < tw_words; e += blockDim.x) copy4(to + e, from + e);
  };

  // Column pairs: `groups` threads share a pair, each walking every
  // groups-th row of the strip.
  const int groups = max(1, (int)blockDim.x / pl.tp);

  // out[p][t] = sum_k cw[t][k] . T[p][cidx[t][k]] for the strip rows
  // g, g + groups, ... of the tile whose output rows are `trow`.
  auto col_rows = [&](const ColTaps<KC>& ct, int g, int n, const int* trow) {
    for (int rho = g; rho < 2 * pl.rt; rho += groups) {
      const int p = trow[rho];
      if (p < 0) continue;
      const float* row = Ts + (size_t)rho * pl.ts_stride;
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float v = row[ct.col[kk]];
        a = fmaf(ct.wa[kk], v, a);
        b = fmaf(ct.wb[kk], v, b);
      }
      for (int kk = KC; kk < pl.k; ++kk) {
        const float v = row[ct.ci[kk * pl.tp]];
        a = fmaf(ct.cwa[kk * pl.tp], v, a);
        b = fmaf(ct.cwa[(pl.k + kk) * pl.tp], v, b);
      }
      float* o = store.out + store.row(n, p);
      o[ct.ca] = a;
      if (ct.has_b) o[ct.cb] = b;
    }
  };

  int work = blockIdx.x;
  if (pl.cols_shared)
    for (int e = threadIdx.x; e < col_words(pl.tp, pl.k); e += blockDim.x)
      copy4(cols_smem + e, pl.cols + e);  // lands with the first tile's group
  int qnext = slot_rows(work);
  if (pl.stages == 2) {
    if (work < nwork) issue(work, smem, qnext);
    qnext = slot_rows(work + gridDim.x);
  }
  commit();
  for (int it = 0; work < nwork; ++it, work += gridDim.x) {
    float* cur = smem;
    if (pl.stages == 2) {
      cur += (it & 1) * stage_floats;
      const int next = work + gridDim.x;
      if (next < nwork) issue(next, smem + ((it + 1) & 1) * stage_floats, qnext);
      qnext = slot_rows(next + gridDim.x);  // lands while this tile computes
      commit();
      wait_pending<1>();  // every group but the newest is done: `cur` has landed
    } else {
      issue(work, cur, qnext);
      qnext = slot_rows(work + gridDim.x);
      commit();
      wait_pending<0>();
    }
    __syncthreads();
    const int n = work / pl.ntiles;
    const int* trow = reinterpret_cast<const int*>(cur + rows_floats);
    const int* tidx = trow + 2 * pl.rt;
    const float* tw = reinterpret_cast<const float*>(tidx + pl.rt * pl.k);

    // Row pass: T[2r + h][c] = sum_k tw[r][h][k] . stage[tidx[r][k]][c].
    for (int r = warp; r < pl.rt; r += nwarps) {
      if (trow[2 * r] < 0) continue;  // the ragged end of the last tile
      const int* ti = tidx + r * pl.k;
      const float* twa = tw + 2 * r * pl.k;
      const float* twb = twa + pl.k;
      int off[KC];
      float wa[KC], wb[KC];
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        off[kk] = ti[kk] * S;
        wa[kk] = twa[kk];
        wb[kk] = twb[kk];
      }
      float* ta = Ts + (size_t)(2 * r) * pl.ts_stride;
      float* tb = ta + pl.ts_stride;
      for (int c = lane; c < S; c += 32) {
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
          const float v = cur[off[kk] + c];
          a = fmaf(wa[kk], v, a);
          b = fmaf(wb[kk], v, b);
        }
        for (int kk = KC; kk < pl.k; ++kk) {  // taps past the first KC (filters over 16 long)
          const float v = cur[ti[kk] * S + c];
          a = fmaf(twa[kk], v, a);
          b = fmaf(twb[kk], v, b);
        }
        const int pc = pl.odd_off == 0 ? c : (c & 1) ? pl.odd_off + (c >> 1) : (c >> 1);
        ta[pc] = a;
        tb[pc] = b;
      }
    }
    __syncthreads();

    // Column pass.
    for (int u = threadIdx.x; u < groups * pl.tp; u += blockDim.x) {
      ColTaps<KC> ct;
      ct.load(cols, pl.tp, pl.k, u % pl.tp, store);
      col_rows(ct, u / pl.tp, n, trow);
    }
    __syncthreads();  // T and this stage are rewritten in the next round
  }
}

// Blocks of `kernel` that fit on one SM at (threads, smem), per device,
// computed once and kept (the occupancy query costs microseconds a launch).
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int device, int threads, size_t smem, int* out) {
  struct Entry {
    int device, threads;
    size_t smem;
    int blocks;
  };
  static Entry cache[64];
  static int used = 0;
  static std::mutex mu;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < used; ++i)
      if (cache[i].device == device && cache[i].threads == threads && cache[i].smem == smem) {
        *out = cache[i].blocks;
        return 0;
      }
  }
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(mu);
  if (used < 64) cache[used++] = Entry{device, threads, smem, blocks};
  *out = blocks;
  return 0;
}

// Launches on `stream`, on the calling thread's current device, and returns
// cudaGetLastError() (0 on success). The caller sets the device, allocates
// the output and checks shapes and the shared-memory size; N >= 1. The
// dynamic shared-memory cap is raised to the device's opt-in maximum on the
// first launch there; the grid is as many blocks as fit on the SMs at once.
template <int KC, typename Source, typename Store>
int launch_kc(Source src, Store store, const Plan& pl, int N, int S, void* stream) {
  static std::atomic<bool> configured[kMaxDevices];
  static int sm_count[kMaxDevices];
  auto kernel = band2_kernel<KC, Source, Store>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  if (device >= kMaxDevices || !configured[device].load(std::memory_order_acquire)) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    if (device < kMaxDevices) {
      sm_count[device] = sms;
      configured[device].store(true, std::memory_order_release);
    }
  } else {
    sms = sm_count[device];
  }
  const int threads = block_threads(pl.tp);
  const size_t smem =
      smem_bytes(S, pl.sm, pl.rt, pl.k, pl.tp, pl.ts_stride, pl.stages, pl.cols_shared);
  int per_sm = 0;
  const int occ = blocks_per_sm(kernel, device, threads, smem, &per_sm);
  if (occ != 0) return occ;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long nwork = (long long)N * pl.ntiles;
  const int grid = (int)(nwork < (long long)per_sm * sms ? nwork : (long long)per_sm * sms);
  band2_kernel<KC, Source, Store><<<grid, threads, smem, (cudaStream_t)stream>>>(src, pl, N, S,
                                                                                 store);
  return (int)cudaGetLastError();
}

// KC, the taps held in registers, is the plan's K rounded up to 2, 4, 8 or
// 16 (the plan pads K to it); longer filters keep KC = 16 and loop over the
// rest.
template <typename Source, typename Store>
int launch(Source src, Store store, const void* blob, int kc, int N, int S, int ntiles, int rt,
           int sm, int k, int tp, int odd_off, int ts_stride, int stages, int cols_shared,
           void* stream) {
  const Plan pl = unpack(blob, ntiles, rt, sm, k, tp, odd_off, ts_stride, stages, cols_shared);
  switch (kc) {
    case 2: return launch_kc<2>(src, store, pl, N, S, stream);
    case 4: return launch_kc<4>(src, store, pl, N, S, stream);
    case 8: return launch_kc<8>(src, store, pl, N, S, stream);
    case 16: return launch_kc<16>(src, store, pl, N, S, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace band
