// Kernels K3, K5 and K7: the whole eval Swin block (K3), its window-attention
// half (K5) and the whole train-mode block (K7), on x [B, H, W, C] in fp32 or
// bf16.
//
// K3 replaces the Pallas TPU kernel zs_aac_tpu/ops/window_attn.py::
// _block_kernel, K5 replaces ::_kernel and K7 ::_block_train_kernel. K7 is
// K3 with per-sample drop-path keep scales m1, m2 (rounded to T, as the TPU
// kernel rounds them): y = x + m1 * attn and out = y + m2 * z, and y is
// also written out for the backward (K8 reads it). One template holds all: kMlp
// switches the LN1 in front and the residual + LN2 + MLP + residual behind
// the attention. Because the MLP runs over the hidden dimension in chunks,
// accumulating fc2 in fp32, K3 also computes ::_block_kernel_stream's
// function (K4) at stage-4 shapes (C=768, hidden 3072).
//
// Function (the port's swin_block_plain / window_attention_plain):
//   [K3] xn = LN1(x)   else xn = x
//   window attention on xn: cyclic shift by -s, 8x8 (w x w) windows,
//     qkv = xn Wqkv + b, scores = (q * d^-0.5) k^T + bias[window, head]
//     (relative-position bias plus shift mask), softmax, o = p v,
//     attn = o Wproj + b, windows reversed, shift back by +s
//   [K5] out = attn
//   [K3] y = x + attn, out = y + fc2(gelu(fc1(LN2(y))))
//
// Bound: operations, at HTSAT's shapes. A stage-1 block (B=64, 64x64x96,
// 4 heads of 24) moves ~100 MB and does ~40 GFLOP; the flops of the per-head
// formulation dominate at every stage. The TPU kernel's masked-head
// formulation (h x the score flops, for MXU lane width) is not carried over:
// this kernel computes per head.
//
// Design, one thread block per window:
// - The cyclic shift is folded into the index arithmetic: token (a, b) of
//   rolled-frame window (i, j) lives at ((i*w + a + s) % H, (j*w + b + s) % W)
//   of x, is read from there and written back to the same place. No rolled
//   or partitioned copy of the activation exists.
// - A window's normalized input stays in shared memory (in the activation
//   dtype, channel-major), and the heads are taken one at a time: q, k, v,
//   the N x N scores and the probabilities of one head fit beside it even at
//   C=768 in bf16. Each head's o is written to the window's own rows of
//   `out` and read back for the projection (global writes are visible within
//   the block after __syncthreads), so no second N x C buffer is needed.
// - The MLP runs over row groups of the window (as many rows as fit) and
//   over 64-column chunks of the hidden dimension: fc1 -> GELU for a chunk
//   into shared memory, then its fc2 partial product added into an fp32
//   accumulator. The residual y waits in `out` between the phases.
// - Weights are read from global memory; L2 holds them (3.5 MB for a
//   stage-3 block, 14.2 MB for stage 4, in bf16).
// - The products are CUDA-core FMAs: the head dim (24) is not a multiple of
//   the tensor cores' 16-deep k-step. Each thread computes 8 rows of one
//   output column per item, reading the 8 A values with one vector load
//   from the channel-major shared buffer and the B value from a coalesced
//   row of the weight. These loops are latency-bound, so the launch sizes
//   the block to keep ~32 warps on each SM: 1024 threads where shared memory
//   admits one block per SM (stages 3-4), 512 for two, 256 for three or
//   more (a fixed 256 left stages 3-4 with 8 warps per SM).
//
// Numerics: where the plain version rounds to the activation dtype T (qkv,
// q * scale, probabilities, o, the projection, LN outputs, residual sums,
// GELU output, z) this kernel rounds too; scores, softmax, LN statistics and
// every accumulator are fp32. GELU is exact (erff); LN uses biased variance.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no fast-math: expf, erff and the divisions stay
//        IEEE).

#include "swin_common.cuh"

namespace {

using namespace swin;

struct Params {
  const void* x;
  void* out;
  const void *ln1_s, *ln1_b, *qkv_w, *qkv_b, *proj_w, *proj_b;
  const void *ln2_s, *ln2_b, *fc1_w, *fc1_b, *fc2_w, *fc2_b;
  const float* bias;
  int H, W, C, heads, window, shift, hidden, rows;
  float eps, scale;
  // K7 (train mode) only, else null: the post-attention residual y out and
  // the per-sample drop-path keep scales m1, m2 [B]
  void* y;
  const float *m1, *m2;
};


// Shared-memory bytes of the attention phase and of the MLP phase; the
// launch takes the larger. Layouts (channel-major buffers padded by kPad):
//   attention: qT [d][N+kPad], kT [d][N+kPad], v [N][d], pT [N][N+kPad]
//              (fp32), xa [C][N+kPad] (T)
//   MLP:       z [C][R+kPad], hm [kChunk][R+kPad] (fp32), yn [C][R+kPad] (T)
__host__ __device__ inline int attn_smem(int itemsize, int N, int C, int d) {
  const int ld = N + kPad;
  return align16(4 * (2 * d * ld + N * d + N * ld)) + align16(itemsize * C * ld);
}
__host__ __device__ inline int mlp_smem(int itemsize, int C, int R) {
  const int ld = R + kPad;
  return align16(4 * (C * ld + kChunk * ld)) + align16(itemsize * C * ld);
}

template <typename T, bool kMlp>
__global__ void __launch_bounds__(kMaxThreads) swin_window_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const int H = p.H, W = p.W, C = p.C, w = p.window, s = p.shift;
  const int N = w * w, d = C / p.heads, ldn = N + kPad;
  const int nH = H / w, nW = W / w;
  const int win = blockIdx.x % (nH * nW);
  const int b = blockIdx.x / (nH * nW);
  const int wi = win / nW, wj = win % nW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  T* y = static_cast<T*>(p.y);
  const bool train = kMlp && y != nullptr;
  const float m1 = train ? rnd<T>(p.m1[b]) : 1.f, m2 = train ? rnd<T>(p.m2[b]) : 1.f;

  // element offset of token r's channel 0 (shift folded into the index)
  auto tok = [&](int r) -> int64_t {
    const int hr = (wi * w + r / w + s) % H;
    const int wc = (wj * w + r % w + s) % W;
    return ((static_cast<int64_t>(b) * H + hr) * W + wc) * C;
  };
  // LayerNorm of one row (a warp), written channel-major into dst[c * ld + r]
  auto layer_norm = [&](const T* row, const void* g, const void* be, T* dst, int ldd, int r) {
    const T* gs = static_cast<const T*>(g);
    const T* bs = static_cast<const T*>(be);
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum += ld(row + c);
    const float mean = warp_sum(sum) / C;
    float sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dv = ld(row + c) - mean;
      sq += dv * dv;
    }
    const float inv = 1.f / sqrtf(warp_sum(sq) / C + p.eps);
    for (int c = lane; c < C; c += 32)
      dst[c * ldd + r] = to_t<T>((ld(row + c) - mean) * inv * ld(gs + c) + ld(bs + c));
  };

  float* qT = reinterpret_cast<float*>(smem);
  float* kT = qT + d * ldn;
  float* v = kT + d * ldn;
  float* pT = v + N * d;
  T* xa = reinterpret_cast<T*>(smem + align16(4 * (2 * d * ldn + N * d + N * ldn)));

  // 1. The window's input (LN1 of it for K3), channel-major.
  for (int r = warp; r < N; r += nwarps) {
    if (kMlp) {
      layer_norm(x + tok(r), p.ln1_s, p.ln1_b, xa, ldn, r);
    } else {
      const T* row = x + tok(r);
      for (int c = lane; c < C; c += 32) xa[c * ldn + r] = row[c];
    }
  }
  __syncthreads();

  // 2. Attention, one head at a time; o_h goes to the window's rows of out.
  const T* qkv_w = static_cast<const T*>(p.qkv_w);
  const T* qkv_b = static_cast<const T*>(p.qkv_b);
  for (int hh = 0; hh < p.heads; ++hh) {
    block_gemm(xa, ldn, qkv_w, 3 * C, C, N, 3 * d,
               [&](int vc) { return (vc / d) * C + hh * d + vc % d; },
               [&](int r0, int vc, const float* acc) {
                 const int part = vc / d, j = vc % d;
                 const float bv = ld(qkv_b + part * C + hh * d + j);
#pragma unroll
                 for (int i = 0; i < 8; ++i) {
                   const float val = rnd<T>(acc[i] + bv);
                   if (part == 0) qT[j * ldn + r0 + i] = rnd<T>(val * p.scale);
                   else if (part == 1) kT[j * ldn + r0 + i] = val;
                   else v[(r0 + i) * d + j] = val;
                 }
               });
    __syncthreads();
    const float* bias = p.bias + ((static_cast<int64_t>(win) * p.heads + hh) * N) * N;
    block_gemm(qT, ldn, kT, ldn, d, N, N, [](int c) { return c; },
               [&](int r0, int t, const float* acc) {
#pragma unroll
                 for (int i = 0; i < 8; ++i) pT[t * ldn + r0 + i] = acc[i] + bias[(r0 + i) * N + t];
               });
    __syncthreads();
    for (int r = threadIdx.x; r < N; r += blockDim.x) {
      float m = -INFINITY;
      for (int t = 0; t < N; ++t) m = fmaxf(m, pT[t * ldn + r]);
      float sum = 0.f;
      for (int t = 0; t < N; ++t) {
        const float e = expf(pT[t * ldn + r] - m);
        pT[t * ldn + r] = e;
        sum += e;
      }
      for (int t = 0; t < N; ++t) pT[t * ldn + r] = rnd<T>(pT[t * ldn + r] / sum);
    }
    __syncthreads();
    block_gemm(pT, ldn, v, d, N, N, d, [](int c) { return c; },
               [&](int r0, int j, const float* acc) {
#pragma unroll
                 for (int i = 0; i < 8; ++i) out[tok(r0 + i) + hh * d + j] = to_t<T>(acc[i]);
               });
    __syncthreads();
  }

  // 3. o back into shared memory (channel-major) for the projection.
  for (int idx = threadIdx.x; idx < N * C; idx += blockDim.x) {
    const int r = idx / C, c = idx % C;
    xa[c * ldn + r] = out[tok(r) + c];
  }
  __syncthreads();

  // 4. Projection; K5 writes it, K3 writes the residual y = x + attn (K7:
  //    y = x + m1 * attn, also written to p.y).
  const T* proj_b = static_cast<const T*>(p.proj_b);
  block_gemm(xa, ldn, static_cast<const T*>(p.proj_w), C, C, N, C, [](int c) { return c; },
             [&](int r0, int c, const float* acc) {
               const float bv = ld(proj_b + c);
#pragma unroll
               for (int i = 0; i < 8; ++i) {
                 const int64_t o = tok(r0 + i) + c;
                 float val = rnd<T>(acc[i] + bv);
                 if (train) val = rnd<T>(m1 * val);
                 if (kMlp) val = ld(x + o) + val;
                 out[o] = to_t<T>(val);
                 if (train) y[o] = to_t<T>(val);
               }
             });
  if (!kMlp) return;

  // 5. MLP over row groups of R rows: out = y + fc2(gelu(fc1(LN2(y)))).
  const int R = p.rows, ldr = R + kPad;
  float* z = reinterpret_cast<float*>(smem);
  float* hm = z + C * ldr;
  T* yn = reinterpret_cast<T*>(smem + align16(4 * (C * ldr + kChunk * ldr)));
  const T* fc1_w = static_cast<const T*>(p.fc1_w);
  const T* fc1_b = static_cast<const T*>(p.fc1_b);
  const T* fc2_w = static_cast<const T*>(p.fc2_w);
  const T* fc2_b = static_cast<const T*>(p.fc2_b);
  for (int g0 = 0; g0 < N; g0 += R) {
    __syncthreads();  // y of these rows is in out; shared buffers are free
    for (int r = warp; r < R; r += nwarps) layer_norm(out + tok(g0 + r), p.ln2_s, p.ln2_b, yn, ldr, r);
    for (int idx = threadIdx.x; idx < C * ldr; idx += blockDim.x) z[idx] = 0.f;
    __syncthreads();
    for (int h0 = 0; h0 < p.hidden; h0 += kChunk) {
      const int hc = min(kChunk, p.hidden - h0);
      block_gemm(yn, ldr, fc1_w, p.hidden, C, R, hc, [&](int c) { return h0 + c; },
                 [&](int r0, int c, const float* acc) {
                   const float bv = ld(fc1_b + h0 + c);
#pragma unroll
                   for (int i = 0; i < 8; ++i) hm[c * ldr + r0 + i] = rnd<T>(gelu(acc[i] + bv));
                 });
      __syncthreads();
      block_gemm(hm, ldr, fc2_w + static_cast<int64_t>(h0) * C, C, hc, R, C, [](int c) { return c; },
                 [&](int r0, int c, const float* acc) {
#pragma unroll
                   for (int i = 0; i < 8; ++i) z[c * ldr + r0 + i] += acc[i];
                 });
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < R * C; idx += blockDim.x) {
      const int r = idx / C, c = idx % C;
      const int64_t o = tok(g0 + r) + c;
      float zv = rnd<T>(z[c * ldr + r] + ld(fc2_b + c));
      if (train) zv = rnd<T>(m2 * zv);
      out[o] = to_t<T>(ld(out + o) + zv);
    }
  }
}

template <typename T, bool kMlp>
int launch(const Params& p, int n_blocks, int smem, cudaStream_t stream) {
  auto kernel = swin_window_kernel<T, kMlp>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_blocks, block_threads(smem), smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of dynamic shared memory a launch takes (itemsize: 4 fp32, 2 bf16;
// mlp: 0 = K5, 1 = K3 with `rows` rows per MLP pass).
extern "C" int swin_window_smem(int itemsize, int mlp, int N, int C, int d, int rows) {
  const int a = attn_smem(itemsize, N, C, d);
  if (!mlp) return a;
  const int m = mlp_smem(itemsize, C, rows);
  return a > m ? a : m;
}

// The current device's opt-in limit of shared memory per block.
extern "C" int swin_window_smem_limit() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return 0;
  return v;
}

// dtype: 0 = float32, 1 = bfloat16 (x, out and every weight; bias is fp32).
// mlp: 0 = K5 (attention only), 1 = K3 (whole block); with y, m1 and m2
// given (mlp only) it is K7, the train forward: out = y + m2 * mlp(LN2 y)
// with y = x + m1 * attn(LN1 x) written to y (m1, m2: fp32 [B]). Returns the
// launch's cudaGetLastError() as an int (0 = success).
extern "C" int swin_window(int dtype, int mlp, const void* x, void* out, const void* ln1_s,
                           const void* ln1_b, const void* qkv_w, const void* qkv_b,
                           const void* proj_w, const void* proj_b, const void* ln2_s,
                           const void* ln2_b, const void* fc1_w, const void* fc1_b,
                           const void* fc2_w, const void* fc2_b, const void* bias, int B,
                           int H, int W, int C, int heads, int window, int shift,
                           int hidden, int rows, int chunk, float eps, float scale,
                           void* y, const void* m1, const void* m2, void* stream) {
  const int N = window * window;
  if (chunk != kChunk || heads <= 0 || N % 8 || C % heads || H % window || W % window ||
      (mlp && (rows <= 0 || rows % 8 || N % rows)) ||
      (y != nullptr && (!mlp || m1 == nullptr || m2 == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{x, out, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s, ln2_b,
           fc1_w, fc1_b, fc2_w, fc2_b, static_cast<const float*>(bias),
           H, W, C, heads, window, shift, hidden, rows, eps, scale, y,
           static_cast<const float*>(m1), static_cast<const float*>(m2)};
  const int itemsize = dtype == 0 ? 4 : 2;
  const int smem = swin_window_smem(itemsize, mlp, N, C, C / heads, rows);
  const int n_blocks = B * (H / window) * (W / window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return mlp ? launch<float, true>(p, n_blocks, smem, s)
                             : launch<float, false>(p, n_blocks, smem, s);
  if (dtype == 1) return mlp ? launch<__nv_bfloat16, true>(p, n_blocks, smem, s)
                             : launch<__nv_bfloat16, false>(p, n_blocks, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
