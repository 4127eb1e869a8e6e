// K4 and K5: the ReLU with a packed sign-mask residual and its one-multiply
// backward (the fused ReLU VJP of bind_inference(fused_relu_vjp=True)).
//
// Replaces the TPU kernel wam_tpu/tune/fused_relu.py::_fwd_kernel (K4,
// launched by _pallas_fwd) and wam_tpu/tune/fused_relu.py::_bwd_kernel (K5,
// launched by _pallas_bwd).
//
// Layout, bit for bit the reference's: x is taken flat, as if zero-padded
// to a multiple of 8 x 128 and viewed as (R, 128); the mask is (R/8, 128)
// uint8 with m[r][l] = sum_b [x[8r + b][l] > 0] << b. Here nothing is
// padded: an element past the end is skipped and its bit packs as 0, which
// is what the reference's zero pad gives.
//
// K4: y = x where x > 0 (NaN passes through, as torch.relu and jnp.maximum
// give), else 0; m as above. K5: dx = g * bit, the gate x > 0, so the
// gradient at exactly 0 is 0. float32 and bfloat16; bfloat16 is compared
// and multiplied in float, which is exact for a 0/1 factor.
//
// Bound on an H100: HBM bytes. Per float32 element K4 reads 4 B and writes
// 4 + 1/8 B, K5 reads 4 + 1/8 B and writes 4 B: 8.125 B each (bfloat16:
// 4.125 B), against one compare or one multiply. Design: one thread per
// mask byte (r, l) handles the 8 elements (8r + b) * 128 + l, so the 32
// threads of a warp touch 32 neighbouring elements on every access (each
// load and store is coalesced) and the byte is assembled in a register.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace wam_relu {

constexpr long long kLanes = 128;
constexpr int kPack = 8;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;  // a grid-stride loop covers the rest

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    relu_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, uint8_t* __restrict__ m,
                    long long n, long long n_bytes) {
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x; j < n_bytes;
       j += (long long)gridDim.x * kThreads) {
    const long long base = (j / kLanes) * (kPack * kLanes) + j % kLanes;
    unsigned bits = 0;
#pragma unroll
    for (int b = 0; b < kPack; ++b) {
      const long long i = base + b * kLanes;
      if (i < n) {
        const T v = x[i];
        const float f = to_float(v);
        const bool pos = f > 0.f;
        bits |= (unsigned)pos << b;
        if (pos || f != f) {
          y[i] = v;
        } else {
          from_float(0.f, y + i);
        }
      }
    }
    m[j] = (uint8_t)bits;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    relu_bwd_kernel(const uint8_t* __restrict__ m, const T* __restrict__ g,
                    T* __restrict__ dx, long long n, long long n_bytes) {
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x; j < n_bytes;
       j += (long long)gridDim.x * kThreads) {
    const long long base = (j / kLanes) * (kPack * kLanes) + j % kLanes;
    const unsigned bits = m[j];
#pragma unroll
    for (int b = 0; b < kPack; ++b) {
      const long long i = base + b * kLanes;
      if (i < n) from_float(to_float(g[i]) * (float)((bits >> b) & 1u), dx + i);
    }
  }
}

// Mask bytes for n elements: ceil(n / 1024) rows of 128.
inline long long mask_bytes(long long n) {
  return (n + kPack * kLanes - 1) / (kPack * kLanes) * kLanes;
}

inline unsigned grid_for(long long n_bytes) {
  const long long blocks = (n_bytes + kThreads - 1) / kThreads;
  return (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <typename T>
int relu_fwd(const void* x, void* y, void* m, long long n, void* stream) {
  const long long nb = mask_bytes(n);
  if (nb == 0) return 0;
  relu_fwd_kernel<T><<<grid_for(nb), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<uint8_t*>(m), n, nb);
  return (int)cudaGetLastError();
}

template <typename T>
int relu_bwd(const void* m, const void* g, void* dx, long long n, void* stream) {
  const long long nb = mask_bytes(n);
  if (nb == 0) return 0;
  relu_bwd_kernel<T><<<grid_for(nb), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(m), static_cast<const T*>(g), static_cast<T*>(dx), n, nb);
  return (int)cudaGetLastError();
}

}  // namespace wam_relu

// x, y: n contiguous elements; m: ceil(n / 1024) x 128 uint8. Launch on
// `stream`, on the calling thread's current device; return cudaError_t.
extern "C" int wam_relu_fwd_f32(const void* x, void* y, void* m, long long n, void* stream) {
  return wam_relu::relu_fwd<float>(x, y, m, n, stream);
}

extern "C" int wam_relu_fwd_bf16(const void* x, void* y, void* m, long long n, void* stream) {
  return wam_relu::relu_fwd<__nv_bfloat16>(x, y, m, n, stream);
}

// m: ceil(n / 1024) x 128 uint8; g, dx: n contiguous elements.
extern "C" int wam_relu_bwd_f32(const void* m, const void* g, void* dx, long long n,
                                void* stream) {
  return wam_relu::relu_bwd<float>(m, g, dx, n, stream);
}

extern "C" int wam_relu_bwd_bf16(const void* m, const void* g, void* dx, long long n,
                                 void* stream) {
  return wam_relu::relu_bwd<__nv_bfloat16>(m, g, dx, n, stream);
}
