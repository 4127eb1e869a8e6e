// Two-sided batched matrix product, out[n] = M1 . X[n] . M2, the body of
// the level-collapsed synthesis K3 (pair.cu). K1 and K2 run the banded
// product of band2.cuh instead.
//
// Shapes: M1 is P x Q (passed transposed, as the contiguous Q x P matrix
// M1T), X[n] is Q x S, M2 is S x T, out[n] is P x T, all float32 (X read
// through DenseSource). Everything accumulates in float32 with plain FMAs
// on the CUDA cores: no tensor cores and no TF32, so the result matches a
// float32 matmul pair up to summation order.
//
// One block owns kRows consecutive output rows of one image. It computes
// the kRows x S strip T = M1[rows] . X[n] into shared memory, streaming X
// once along its rows (coalesced along S) against kChunk staged rows of
// M1T, then computes T . M2, streaming M2 the same way, and hands each
// output element to the caller's Store (the epilogue).
//
// What bounds it on an H100: the function needs only the products of the
// operators' nonzeros (R is banded, Y of the collapsed synthesis is
// block-diagonal), and at the wavelet shapes that work is bound by HBM
// bytes, not FLOP. This routine does the dense 2.P.S.(Q + T) FLOP per
// image instead, so the f32 CUDA-core rate is what bounds it. It keeps both
// products on chip (T never reaches device memory) and reads each M1 value
// from shared memory once per kCols columns and each X/M2 value once per
// kRows rows. Skipping Y's zero blocks and R's zeros, as band2.cuh does for
// K1 and K2, is the next lever.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

namespace wam {

constexpr int kRows = 16;     // output rows per block (rows of M1)
constexpr int kThreads = 256;
constexpr int kCols = 2;      // columns per thread per pass over a row strip
constexpr int kChunk = 64;    // rows of M1T staged in shared memory per step

// acc[i][c] += sum_k L[k][i] * R[k * ld + col_c] for k < k_count, where
// L lives in shared memory (kRows floats per k, 16-byte aligned) and R
// points at row 0 in global memory, rows ld elements apart;
// col_c = c0 + tid + c * kThreads < ncols.
template <typename TR>
__device__ __forceinline__ void accumulate(float (&acc)[kRows][kCols],
                                           const float* __restrict__ L,
                                           const TR* __restrict__ R, size_t ld,
                                           int k_count, int c0, int ncols) {
  int col[kCols];
  bool ok[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    col[c] = c0 + threadIdx.x + c * kThreads;
    ok[c] = col[c] < ncols;
  }
#pragma unroll 4
  for (int k = 0; k < k_count; ++k) {
    float r[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      r[c] = ok[c] ? R[(size_t)k * ld + col[c]] : 0.f;
    const float4* l4 = reinterpret_cast<const float4*>(L + k * kRows);
#pragma unroll
    for (int i4 = 0; i4 < kRows / 4; ++i4) {
      const float4 l = l4[i4];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        acc[4 * i4 + 0][c] = fmaf(l.x, r[c], acc[4 * i4 + 0][c]);
        acc[4 * i4 + 1][c] = fmaf(l.y, r[c], acc[4 * i4 + 1][c]);
        acc[4 * i4 + 2][c] = fmaf(l.z, r[c], acc[4 * i4 + 2][c]);
        acc[4 * i4 + 3][c] = fmaf(l.w, r[c], acc[4 * i4 + 3][c]);
      }
    }
  }
}

// X[n] as a dense row-major (N, Q, S) tensor. A Source adds
// sum_k L[k][i] * X[n][q0 + k][col_c] for k < kc to acc.
template <typename TX>
struct DenseSource {
  const TX* x;
  int Q, S;
  __device__ __forceinline__ void accumulate(float (&acc)[kRows][kCols], const float* L,
                                             int n, int q0, int kc, int c0) const {
    wam::accumulate(acc, L, x + ((size_t)n * Q + q0) * S, (size_t)S, kc, c0, S);
  }
};

// The epilogue of a plain product: out[n] row-major (N, P, T).
struct RowMajorStore {
  float* out;
  int P, T;
  __device__ __forceinline__ void operator()(int n, int p, int t, float v) const {
    out[((size_t)n * P + p) * T + t] = v;
  }
};

__device__ __forceinline__ void zero(float (&acc)[kRows][kCols]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
}

// Dynamic shared memory: kChunk x kRows staged M1T values, then the
// S x kRows strip T (column-major in the strip, so one k reads 4 float4s).
template <typename Source, typename Store>
__global__ void __launch_bounds__(kThreads)
    mm2_kernel(Source src, const float* __restrict__ M1T,
               const float* __restrict__ M2, int N, int P, int Q, int S, int T,
               Store store) {
  extern __shared__ __align__(16) float smem[];
  float* Ls = smem;
  float* Ts = smem + kChunk * kRows;
  const int p0 = blockIdx.x * kRows;

  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    // T = M1[p0 : p0 + kRows] . X[n]
    for (int c0 = 0; c0 < S; c0 += kThreads * kCols) {
      float acc[kRows][kCols];
      zero(acc);
      for (int q0 = 0; q0 < Q; q0 += kChunk) {
        const int kc = min(kChunk, Q - q0);
        __syncthreads();  // every thread is done with the previous chunk
        for (int idx = threadIdx.x; idx < kc * kRows; idx += kThreads) {
          const int k = idx / kRows, i = idx % kRows;
          Ls[idx] = (p0 + i < P) ? M1T[(size_t)(q0 + k) * P + p0 + i] : 0.f;
        }
        __syncthreads();
        src.accumulate(acc, Ls, n, q0, kc, c0);
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = c0 + threadIdx.x + c * kThreads;
        if (col < S) {
          float4* t4 = reinterpret_cast<float4*>(Ts + (size_t)col * kRows);
#pragma unroll
          for (int i4 = 0; i4 < kRows / 4; ++i4)
            t4[i4] = make_float4(acc[4 * i4][c], acc[4 * i4 + 1][c],
                                 acc[4 * i4 + 2][c], acc[4 * i4 + 3][c]);
        }
      }
    }
    __syncthreads();
    // out[n][p0 : p0 + kRows] = T . M2
    for (int c0 = 0; c0 < T; c0 += kThreads * kCols) {
      float acc[kRows][kCols];
      zero(acc);
      accumulate(acc, Ts, M2, (size_t)T, S, c0, T);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = c0 + threadIdx.x + c * kThreads;
        if (col >= T) continue;
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          if (p0 + i < P) store(n, p0 + i, col, acc[i][c]);
      }
    }
    __syncthreads();  // Ts is rewritten for the next image
  }
}

inline size_t smem_bytes(int S) {
  return (size_t)(kChunk + S) * kRows * sizeof(float);
}

constexpr int kMaxDevices = 64;

// Launches on `stream`, on the calling thread's current device, and returns
// cudaGetLastError() (0 on success). The caller sets the device, allocates
// `out` and checks shapes; N >= 1. The dynamic shared-memory cap is a
// per-device attribute of the function: it is raised to the device's
// opt-in maximum on the first launch there.
template <typename Source, typename Store>
int launch(Source src, const void* m1t, const void* m2, Store store, int N,
           int P, int Q, int S, int T, void* stream) {
  static std::atomic<bool> configured[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices || !configured[device].load(std::memory_order_acquire)) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(mm2_kernel<Source, Store>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return (int)err;
    if (device < kMaxDevices) configured[device].store(true, std::memory_order_release);
  }
  const dim3 grid((P + kRows - 1) / kRows, N < 65535 ? N : 65535);
  mm2_kernel<Source, Store><<<grid, kThreads, smem_bytes(S), (cudaStream_t)stream>>>(
      src, static_cast<const float*>(m1t), static_cast<const float*>(m2), N, P, Q, S, T,
      store);
  return (int)cudaGetLastError();
}

}  // namespace wam
