// The two elementwise passes around every w8a8 GEMM, one kernel each:
//
// - quant_act_kernel: dynamic per-row int8 quantization of the activations
//   (ops/quant.py::quant_act): a row's abs-max, s = max(amax / 127, 1e-8),
//   q = clip(round_half_even(x / s), -127, 127);
// - int8_rescale_kernel: the GEMM's int32 result back to the activation dtype
//   (ops/quant.py::int8_rescale): out = dtype((float(y) * sx) * w_scale),
//   then + bias in the output dtype.
//
// They replace no TPU kernel. On the TPU XLA fused both chains into the
// neighbouring ops (zs_aac_tpu/models/gpt2.py::_quant_act, _int8_dot); on the
// card they ran as chains of 8-10 and 4-5 ATen elementwise kernels, each a
// full pass over the [M, K] activations or the [M, N] result.
//
// Numerics: bitwise those of the plain PyTorch versions for every finite
// input. The abs-max is exact in any order; every other step is one IEEE
// operation in the plain version's order (__fdiv_rn, rintf, __fmul_rn,
// __fadd_rn: nothing contracts into an FMA), and the bf16 output rounds once,
// to nearest even, as ATen's cast does. A bf16 bias is added as ATen adds two
// bf16 tensors: both widened to fp32, one fp32 add, one rounding.
//
// Bound: bytes, a few flops a byte. Quantize reads each input element once
// and writes one int8 (and a scale a row): (sizeof(x) + 1) bytes an element.
// Rescale reads an int32 and writes the output: (4 + sizeof(out)) bytes.
//
// Design (ops/quant.py::quant_plan and rescale_plan pick the instantiation):
// - Quantize: a row group of `tpr` threads (a warp, or whole warps) per row,
//   `rows` groups a block. Each thread loads up to kItems vectors of 16 bytes
//   (4 fp32 or 8 bf16; single elements where K or the rows' alignment does
//   not allow) and keeps them in registers; the abs-max reduces by warp
//   shuffles, then across the group's warps through shared memory; the same
//   registers are divided, rounded and stored as packed int8 (4 or 8 bytes).
// - Rescale: a thread owns `vec` (4) adjacent columns of a column tile and
//   kRows rows. It reads its columns' w_scale and bias once, then issues the
//   kRows 16-byte loads of the int32 rows before it converts and stores any.
//   Rows run along the grid's x (up to 2^31 - 1 blocks), column tiles along y.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no fast-math: the divisions must stay IEEE and
//        denormals must not flush).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;   // rows a rescale thread handles
constexpr int kItems = 8;  // loads a quantize thread keeps in registers

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<1> { using type = unsigned char; };

// V elements of E, moved as one access of V * sizeof(E) bytes
template <typename E, int V>
union Pack {
  typename Raw<sizeof(E) * V>::type raw;
  E e[V];
};

// bf16 values travel as their bits (unsigned short); widening is exact
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(unsigned short b) {
  return __uint_as_float(static_cast<unsigned int>(b) << 16);
}
__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <typename E, int V>
__global__ void quant_act_kernel(const E* __restrict__ x, signed char* __restrict__ q,
                                 float* __restrict__ scale, int M, int K, int tpr) {
  __shared__ float red[32];
  const int group = threadIdx.x / tpr;  // the block's row this thread serves
  const int t = threadIdx.x - group * tpr;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / tpr) + group;
  const bool live = row < M;
  const int nvec = K / V;
  using P = Pack<E, V>;
  const P* src = reinterpret_cast<const P*>(x + (live ? row : 0) * K);
  P v[kItems];
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = t + i * tpr;
    if (live && j < nvec) v[i].raw = src[j].raw;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (live && t + i * tpr < nvec) {
#pragma unroll
      for (int k = 0; k < V; ++k) m = fmaxf(m, fabsf(to_float(v[i].e[k])));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const int wpr = tpr >> 5;  // the same for the whole block
  if (wpr > 1) {
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
    __syncthreads();
    m = red[group * wpr];
    for (int w = 1; w < wpr; ++w) m = fmaxf(m, red[group * wpr + w]);
  }
  if (!live) return;
  const float s = fmaxf(__fdiv_rn(m, 127.f), 1e-8f);
  if (t == 0) scale[row] = s;
  using Q = Pack<signed char, V>;
  Q* dst = reinterpret_cast<Q*>(q + row * K);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = t + i * tpr;
    if (j < nvec) {
      Q out;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float r = fminf(fmaxf(rintf(__fdiv_rn(to_float(v[i].e[k]), s)), -127.f), 127.f);
        out.e[k] = static_cast<signed char>(__float2int_rn(r));
      }
      dst[j].raw = out.raw;
    }
  }
}

template <typename OE, int V>
__global__ void int8_rescale_kernel(const int* __restrict__ y, const float* __restrict__ sx,
                                    const float* __restrict__ ws, const OE* __restrict__ bias,
                                    OE* __restrict__ out, int M, int N) {
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (c >= N) return;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  float w[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    w[k] = ws[c + k];
    b[k] = bias ? to_float(bias[c + k]) : 0.f;
  }
  using Y = Pack<int, V>;
  using O = Pack<OE, V>;
  Y yv[kRows];
  float s[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long r = r0 + i;
    if (r < M) {
      yv[i].raw = reinterpret_cast<const Y*>(y + r * N + c)->raw;
      s[i] = sx[r];
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long r = r0 + i;
    if (r >= M) break;
    O o;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float v = __fmul_rn(__fmul_rn(__int2float_rn(yv[i].e[k]), s[i]), w[k]);
      if constexpr (sizeof(OE) == 2) {
        const unsigned short h = bf16_bits(v);
        o.e[k] = bias ? bf16_bits(__fadd_rn(to_float(h), b[k])) : h;
      } else {
        o.e[k] = bias ? __fadd_rn(v, b[k]) : v;
      }
    }
    reinterpret_cast<O*>(out + r * N + c)->raw = o.raw;
  }
}

template <typename E, int V>
cudaError_t launch_quant(int tpr, int rows, const void* x, void* q, void* scale, int M, int K,
                         cudaStream_t s) {
  quant_act_kernel<E, V><<<(M + rows - 1) / rows, tpr * rows, 0, s>>>(
      static_cast<const E*>(x), static_cast<signed char*>(q), static_cast<float*>(scale), M, K,
      tpr);
  return cudaGetLastError();
}

template <typename OE>
cudaError_t launch_rescale(int vec, int threads, const void* y, const void* sx, const void* ws,
                           const void* bias, void* out, int M, int N, cudaStream_t s) {
  const int tiles = (N / vec + threads - 1) / threads;
  const dim3 grid((M + kRows - 1) / kRows, tiles), block(threads);
  auto yp = static_cast<const int*>(y);
  auto sp = static_cast<const float*>(sx);
  auto wp = static_cast<const float*>(ws);
  auto bp = static_cast<const OE*>(bias);
  auto op = static_cast<OE*>(out);
  switch (vec) {
    case 4: int8_rescale_kernel<OE, 4><<<grid, block, 0, s>>>(yp, sp, wp, bp, op, M, N); break;
    case 2: int8_rescale_kernel<OE, 2><<<grid, block, 0, s>>>(yp, sp, wp, bp, op, M, N); break;
    case 1: int8_rescale_kernel<OE, 1><<<grid, block, 0, s>>>(yp, sp, wp, bp, op, M, N); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 fp32, 1 bf16. x [M, K], q [M, K] int8 and scale [M] fp32, all
// contiguous.
extern "C" int quant_act(int dtype, int vec, int tpr, int rows, const void* x, void* q,
                         void* scale, int M, int K, void* stream) {
  if (M <= 0 || K <= 0 || vec <= 0 || K % vec || tpr < 32 || tpr % 32 || rows < 1 ||
      tpr * rows > 1024 || static_cast<long long>(tpr) * kItems < K / vec)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) return launch_quant<float, 4>(tpr, rows, x, q, scale, M, K, s);
  if (dtype == 0 && vec == 1) return launch_quant<float, 1>(tpr, rows, x, q, scale, M, K, s);
  if (dtype == 1 && vec == 8)
    return launch_quant<unsigned short, 8>(tpr, rows, x, q, scale, M, K, s);
  if (dtype == 1 && vec == 1)
    return launch_quant<unsigned short, 1>(tpr, rows, x, q, scale, M, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out_dtype: 0 fp32, 1 bf16. y [M, N] int32 contiguous, sx [M] and ws [N]
// fp32, bias [N] in the output dtype or null, out [M, N].
extern "C" int int8_rescale(int out_dtype, int vec, int threads, const void* y, const void* sx,
                            const void* ws, const void* bias, void* out, int M, int N,
                            void* stream) {
  if (M <= 0 || N <= 0 || vec <= 0 || N % vec || threads < 32 || threads % 32 ||
      threads > 1024 || (N / vec + threads - 1) / threads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return launch_rescale<float>(vec, threads, y, sx, ws, bias, out, M, N, s);
  if (out_dtype == 1)
    return launch_rescale<unsigned short>(vec, threads, y, sx, ws, bias, out, M, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
