// Device helpers shared by the Swin kernels (window_attn.cu: K3, K5, K7;
// swin_train.cu: K6, K8, K9): typed loads and stores, rounding through the
// activation dtype, vector loads from shared memory, the exact GELU, the
// small block-wide FMA product of the fp32 kernels, and the bf16 tensor-core
// tiles (mma.sync fragments, ldmatrix, cp.async and the staged-weight
// product) of the bf16 kernels.
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

// -- bf16 tensor-core tiles ----------------------------------------------------
//
// Fragments of mma.sync.m16n8k16 (bf16 in, fp32 out), g = lane / 4 and
// t = lane % 4:
//   A 16x16 (row):  a[0] = (row g, k 2t..2t+1), a[1] = (row g+8, same k),
//                   a[2] = (row g, k 2t+8..), a[3] = (row g+8, k 2t+8..)
//   B 16x8 (col):   b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g)
//   C 16x8:         c[0..1] = (row g, n 2t..2t+1), c[2..3] = (row g+8, same n)
// so two neighbouring C tiles, rounded to bf16, are the A fragment of the next
// product (q into q k^T, p into p v) without leaving the registers.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8 (16 bytes, 16-byte aligned). Plain: thread gets (row g, columns
// 2t..2t+1) of each matrix; .trans: (rows 2t..2t+1, column g).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// Two matrices, addresses from lanes 0-15.
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

__device__ __forceinline__ void mma_k16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// The 8-deep step: a0 = (row g, k 2t..2t+1), a1 = (row g+8, same k), b0 =
// (k 2t..2t+1, n g).
__device__ __forceinline__ void mma_k8(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]) : "r"(a0), "r"(a1), "r"(b0));
}

// Two floats rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// 8 bf16 values (16 bytes) to and from floats.
__device__ __forceinline__ void unpack8(const uint4& u, float v[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = unpack2(w[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ uint4 pack8(const float v[8]) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}
// The same, or 16 bytes of zeros where `valid` is false (gmem is not read then).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

constexpr int kSlabRows = 32;  // weight rows (k) per staged slab: two 16-deep steps
constexpr int kSlabStages = 3; // slab buffers: the copies run two slabs ahead
constexpr int kSlabCopies = 3; // most 16-byte copies a thread makes per slab (the default)

// Row length (elements) of a bf16 shared-memory tile of `cols` columns whose
// 16-byte chunks per row are odd in number, so that the 8 rows of an ldmatrix
// fall into 8 different bank groups.
__host__ __device__ inline int odd_ld(int cols) { return (cols / 8) % 2 ? cols : cols + 8; }

// acc (a warp's 16 rows x 8*kTiles columns, as C fragments) += A W on the
// tensor cores. A: bf16 rows in shared memory, a_addr the shared address this
// lane gives ldmatrix: &A[row0 + lane % 16][(lane / 16) * 8]. W: K rows (a
// multiple of kSlabRows) that the whole block stages from global memory, slab
// by slab, with 16-byte cp.async into kSlabStages buffers at `slab` (row
// length slab_ld = odd_ld(8 * chunks)): src(k, c8) is the global address of
// the 8 values for slab columns 8*c8.. of row k < kSlabRows, and rows lie w_ld
// elements apart, so a thread works out its (at most kCopies: kSlabRows *
// chunks copies over the block's threads) addresses
// once a call and steps them from slab to slab; col0 is this warp's first
// slab column. The copies run two slabs ahead of the products, with one
// __syncthreads a slab: it makes slab s visible and frees the buffer of slab
// s-1 for slab s+2. Every thread of the block calls it; it returns after a
// __syncthreads, when the buffers are free and every warp's reads of A are
// done.
template <int kTiles, int kCopies = kSlabCopies, typename Src>
__device__ __forceinline__ void staged_gemm(float (&acc)[kTiles][4], uint32_t a_addr, int K,
                                            __nv_bfloat16* slab, int slab_ld, int chunks,
                                            int col0, int64_t w_ld, Src src) {
  const int lane = threadIdx.x & 31;
  const int stage = kSlabRows * slab_ld;
  const int nslab = K / kSlabRows;
  const __nv_bfloat16* from[kCopies];
  int to[kCopies];
#pragma unroll
  for (int j = 0; j < kCopies; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    const int kr = i / chunks, c8 = i - kr * chunks;
    to[j] = kr < kSlabRows ? kr * slab_ld + c8 * 8 : -1;
    from[j] = kr < kSlabRows ? src(kr, c8) : nullptr;
  }
  // one commit group a call, empty past the last slab, so the wait below
  // counts the same at every step
  auto copy_slab = [&](int s) {
    if (s < nslab) {
      __nv_bfloat16* dst = slab + (s % kSlabStages) * stage;
#pragma unroll
      for (int j = 0; j < kCopies; ++j)
        if (to[j] >= 0) cp_async16(dst + to[j], from[j] + s * kSlabRows * w_ld);
    }
    cp_async_commit();
  };
  static_assert(kSlabStages == 3, "the prologue below copies two slabs");
  copy_slab(0);
  copy_slab(1);
  for (int s = 0; s < nslab; ++s) {
    cp_async_wait<kSlabStages - 2>();
    __syncthreads();
    copy_slab(s + kSlabStages - 1);
    const __nv_bfloat16* w = slab + (s % kSlabStages) * stage + (lane & 15) * slab_ld + col0;
#pragma unroll
    for (int kk = 0; kk < kSlabRows / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, a_addr + (s * kSlabRows + kk * 16) * 2);
      const uint32_t b_addr = smem_addr(w + kk * 16 * slab_ld);
#pragma unroll
      for (int np = 0; np < kTiles / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, b_addr + (np * 16 + (lane >> 4) * 8) * 2);
        mma_k16(acc[2 * np], a, b[0], b[1]);
        mma_k16(acc[2 * np + 1], a, b[2], b[3]);
      }
      if (kTiles & 1) {
        uint32_t b[2];
        ldsm_x2_t(b, b_addr + (kTiles - 1) * 8 * 2);
        mma_k16(acc[kTiles - 1], a, b[0], b[1]);
      }
    }
  }
  __syncthreads();
}

}  // namespace swin
