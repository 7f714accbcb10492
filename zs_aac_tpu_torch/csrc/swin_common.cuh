// Device helpers shared by the Swin kernels (window_attn.cu: K3, K5, K7;
// swin_train.cu: K6, K8, K9): typed loads and stores, rounding through the
// activation dtype, vector loads from shared memory, the exact GELU and the
// small block-wide product every kernel's matmuls go through.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace swin {

constexpr int kMaxThreads = 1024;
constexpr int kPad = 8;     // extra elements per channel-major row (bank spread)
constexpr int kChunk = 64;  // hidden (or reduction) columns per chunk

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T> __device__ __forceinline__ T to_t(float x);
template <> __device__ __forceinline__ float to_t<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 to_t<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round through T (the identity for fp32).
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 8 consecutive values from shared memory (16-byte aligned).
__device__ __forceinline__ void ld8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// d/dx of the exact GELU: Phi(x) + x phi(x).
__device__ __forceinline__ float gelu_grad(float x) {
  return 0.5f * (1.f + erff(x * 0.70710678118654752f)) +
         x * expf(-0.5f * x * x) * 0.39894228040143268f;
}

// out(r, c) = sum_k A[k * lda + r] * B[k * ldb + bcol(c)] for r < nrows
// (a multiple of 8) and c < ncols. A lies in shared memory, k-major; B in
// global or shared memory. Each work item is 8 rows of one column, handed
// to epi(r0, c, acc[8]); consecutive threads take consecutive columns.
template <typename TA, typename TB, typename BCol, typename Epi>
__device__ __forceinline__ void block_gemm(const TA* A, int lda, const TB* B, int ldb,
                                           int K, int nrows, int ncols, BCol bcol, Epi epi) {
  const int items = (nrows >> 3) * ncols;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int c = it % ncols, r0 = (it / ncols) << 3;
    const TB* bp = B + bcol(c);
    const TA* ap = A + r0;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float a[8];
      ld8(ap + k * lda, a);
      const float bv = ld(bp + static_cast<int64_t>(k) * ldb);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(a[i], bv, acc[i]);
    }
    epi(r0, c, acc);
  }
}

__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }

// Threads per block: ~1024 per SM over the blocks that shared memory lets
// one SM hold (1 KB of it is reserved per block), in multiples of 256.
inline int block_threads(int smem) {
  int dev = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev) !=
          cudaSuccess) {
    return 256;
  }
  const int blocks = per_sm / (smem + 1024) > 1 ? per_sm / (smem + 1024) : 1;
  const int threads = kMaxThreads / blocks / 256 * 256;
  return threads > 256 ? threads : 256;
}

// The current device's opt-in limit of shared memory per block.
inline int smem_limit() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return v;
}

}  // namespace swin
