// Kernels K3, K5 and K7: the whole eval Swin block (K3), its window-attention
// half (K5) and the whole train-mode block (K7), on x [B, H, W, C] in fp32 or
// bf16.
//
// K3 replaces the Pallas TPU kernel zs_aac_tpu/ops/window_attn.py::
// _block_kernel, K5 replaces ::_kernel and K7 ::_block_train_kernel. K7 is
// K3 with per-sample drop-path keep scales m1, m2 (rounded to T, as the TPU
// kernel rounds them): y = x + m1 * attn and out = y + m2 * z, and y is
// also written out for the backward (K8 reads it). The MLP runs over the
// hidden dimension in chunks, so K3 also computes ::_block_kernel_stream's
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
// Bound: operations. Per token the block is 24 C^2 + 4 N C flops (per-head
// attention) against 4 C bytes of activation in and out: ~62 GFLOP and ~100 MB
// a call at every HTSAT stage with B=64, so the bf16 tensor-core peak (62 us)
// sets the bound, far above the bytes (30 us). The TPU kernel's masked-head
// formulation (h x the score flops, for MXU lane width) is not carried over.
//
// Two instantiations, chosen by shape in ops/window_attn.py::window_kernel_plan:
//
// 1. The tensor-core kernels (namespace tc; bf16, 64-token windows, head dim
//    24, C = 96 * {1, 2, 4, 8}: HTSAT's four stages). What the design does
//    about the bound:
//    - Every product (qkv, q k^T, p v, projection, fc1, fc2) is mma.sync
//      m16n8k16 on bf16 operands with fp32 accumulators in registers. A warp
//      owns 16 rows (an m16 tile) and one column group of 96 channels = 4
//      heads; a block is (rows / 16) x (C / 96) warps. Head dim 24 is one
//      16-deep and one 8-deep (m16n8k8) step: nothing is padded.
//    - q never leaves the registers: the qkv accumulators, rounded, are the A
//      fragments of q k^T. k and v of the heads in flight go to shared memory
//      as bf16 tiles. Bias add, row max, exp, row sum and the rounding of p
//      run on the score fragments with quad shuffles in every warp, and the
//      rounded p is the A fragment of p v.
//    - o goes from the p v accumulators into a bf16 [rows][C] tile in shared
//      memory, the A operand of the projection; the residual y and LN2(y)
//      take the place of xn and o there, so an activation is read once and
//      written once (y too in train mode, for K8).
//    - Weights are staged through shared memory in 32-row slabs with 16-byte
//      cp.async, three buffers with the copies two slabs ahead of the
//      products and one barrier a slab, shared by all rows of the block
//      (swin_common.cuh::staged_gemm). The row-wise products take 128 rows
//      (two windows) a block at C <= 192, which halves the L2 traffic of the
//      weights; at C = 384 two windows' tiles do not fit beside the slabs.
//      The weights are not kept resident: at stage 1 all 12 C^2 are 221 KB in
//      bf16, which is the whole shared memory of an SM before any activation
//      tile, and a block that walked over many windows to amortize them
//      would leave 132 blocks with one warp-set each and nothing to overlap
//      the loads with; staging costs ~0.45 GB of L2 reads a call instead
//      (measured: one, two or four windows a block at stage 1 differ by 2-7%,
//      so the weights' traffic is not what holds the kernel back).
//    - Rows move between global and shared memory 16 bytes a thread over the
//      whole tile at once (no per-row loop whose loads wait on each other),
//      and LayerNorm runs on the shared tile with a row's channels held in
//      registers between its passes, 16 lanes a row at C = 96.
//    - fc2 accumulates in registers across the hidden chunks (16 rows x 96
//      columns = 48 registers a thread); GELU (exact erff) is applied on
//      fc1's fragments on their way to the bf16 A tile of fc2.
//    - Stage 4 (C = 768, 64 windows at B=64 for 132 SMs; K5 on the main path,
//      K4's shape): the heads, and then the output columns of the projection
//      and the MLP, are split over two blocks a window, as three kernels of
//      one call with o (and y) in global memory between them; a block's fc2
//      accumulators for 768 columns would not fit its registers either. Each
//      MLP block recomputes fc1 for its half of the output columns.
//    - The cyclic shift is folded into the index arithmetic: token (a, b) of
//      rolled-frame window (i, j) lives at ((i*w + a + s) % H, (j*w + b + s)
//      % W) of x, is read from there and written back to the same place. No
//      rolled or partitioned copy of the activation exists.
//
// 2. The FMA kernel (swin_window_kernel; fp32, and the bf16 shapes the
//    tensor-core kernels do not take): one block per window, heads one at a
//    time through fp32 channel-major buffers, o through the window's rows of
//    `out`, CUDA-core FMAs (fp32 products stay IEEE fp32: TF32 would break
//    the 1e-4 agreement with the recorded fixtures). Blocks are sized to
//    keep ~32 warps on each SM.
//
// Numerics: where the plain version rounds to the activation dtype T (qkv,
// q * scale, probabilities, o, the projection, LN outputs, residual sums,
// GELU output and z) both kernels round too; scores, softmax, LN statistics
// and every accumulator are fp32. GELU is exact (erff); LN uses biased
// variance.
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
  int batch, H, W, C, heads, window, shift, hidden, rows;
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

// -- the tensor-core kernels (bf16, 64-token windows, head dim 24) ---------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kN = 64;        // tokens per window
constexpr int kD = 24;        // head dim
constexpr int kGroup = 96;    // channels per warp column group: 4 heads
constexpr int kHeads = kGroup / kD;
constexpr int kQkv = 3 * kD;  // q, k, v columns of one head
constexpr int kFc1 = 64;      // hidden columns per warp and chunk
constexpr int kKvLd = 40;     // row length of the k and v tiles (odd_ld(24) + 8)
constexpr int kThreads = 512;

// Byte offsets of a block's shared memory: a0 is an [M][C + 8] bf16 row tile
// and a1 one of [M][a1_cols + 8] (none for 0 columns); then k, v of the heads
// in flight ([windows][groups][2][64][kKvLd], attention only), over which the
// MLP lays its hidden chunk [M][groups * 64 + 8]; then the slab buffers of
// [32][groups * 96 + 8].
struct Smem {
  int a1, kv, slab, total;
};
__host__ __device__ inline Smem smem_layout(int M, int C, int groups, int a1_cols, bool attn,
                                            bool mlp) {
  const int a = M * (C + 8) * 2;
  const int kv = attn ? (M / kN) * groups * 2 * kN * kKvLd * 2 : 0;
  const int h = mlp ? M * (groups * kFc1 + 8) * 2 : 0;
  Smem s;
  s.a1 = a;
  s.kv = a + (a1_cols ? M * (a1_cols + 8) * 2 : 0);
  s.slab = s.kv + (kv > h ? kv : h);
  s.total = s.slab + kSlabStages * kSlabRows * (groups * kGroup + 8) * 2;
  return s;
}

// One block's view: M rows = M / 64 windows starting at global window win0
// (over B * nWin, `total` in all), warps laid out as (M / 16) row tiles x
// `groups` column groups of 96 channels starting at group cg0.
struct Blk {
  int M, groups, cg0, win0, total, nWin, lda;
  int warp, lane, mt, wn, g, t;
  bf16 *a0, *a1, *kv, *slab;
};

__device__ __forceinline__ Blk make_blk(const Params& p, unsigned char* smem, int M, int cg0,
                                        int win0, const Smem& lay) {
  Blk b;
  b.M = M;
  b.groups = (blockDim.x >> 5) / (M / 16);
  b.cg0 = cg0;
  b.win0 = win0;
  b.nWin = (p.H / p.window) * (p.W / p.window);
  b.total = p.batch * b.nWin;
  b.lda = p.C + 8;
  b.warp = threadIdx.x >> 5;
  b.lane = threadIdx.x & 31;
  b.mt = b.warp % (M / 16);
  b.wn = b.warp / (M / 16);
  b.g = b.lane >> 2;
  b.t = b.lane & 3;
  b.a0 = reinterpret_cast<bf16*>(smem);
  b.a1 = reinterpret_cast<bf16*>(smem + lay.a1);
  b.kv = reinterpret_cast<bf16*>(smem + lay.kv);
  b.slab = reinterpret_cast<bf16*>(smem + lay.slab);
  return b;
}

// Element offset in x (and out, y) of token r of global window gw: the cyclic
// shift is in the index.
__device__ __forceinline__ int64_t row_offset(const Params& p, int nWin, int gw, int r) {
  const int w = p.window, nW = p.W / w;
  const int b = gw / nWin, win = gw - b * nWin;
  const int hr = ((win / nW) * w + r / w + p.shift) % p.H;
  const int wc = ((win % nW) * w + r % w + p.shift) % p.W;
  return ((static_cast<int64_t>(b) * p.H + hr) * p.W + wc) * p.C;
}

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

// The block's rows into dst [M][lda], 16 bytes a thread over all rows at
// once: from `src` at the tokens' places in [B, H, W, C] (`linear` false) or
// at rows gw * 64 + r of a window-major [B * nWin * 64, C] scratch. Rows of
// windows past the last are zeros.
__device__ __forceinline__ void copy_rows(const Params& p, const Blk& b, const bf16* src,
                                          bool linear, bf16* dst) {
  const int n8 = p.C / 8;
  for (int i = threadIdx.x; i < b.M * n8; i += blockDim.x) {
    const int r = i / n8, c8 = i - r * n8;
    const int gw = b.win0 + r / kN;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gw < b.total) {
      const int64_t off = linear ? (static_cast<int64_t>(gw) * kN + r % kN) * p.C
                                 : row_offset(p, b.nWin, gw, r % kN);
      v = *reinterpret_cast<const uint4*>(src + off + c8 * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * b.lda + c8 * 8) = v;
  }
}

// LayerNorm of the M rows of a shared-memory tile, src [M][lds] -> dst
// [M][ldd] (dst may be src): 16 lanes a row at C <= 128, else a warp; each
// lane keeps its channels (8 a chunk, up to kLnChunks chunks) in registers
// between the passes, so a row is read once and written once.
constexpr int kLnChunks = 3;  // C <= 768 over 32 lanes
__device__ __forceinline__ void layer_norm_tile(const bf16* src, int lds, bf16* dst, int ldd,
                                                int M, int C, const bf16* gs, const bf16* bs,
                                                float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n8 = C / 8;
  const int L = n8 <= 16 ? 16 : 32;  // lanes a row
  const int sl = lane & (L - 1), per_warp = 32 / L;
  for (int r = warp * per_warp + lane / L; r < M; r += (blockDim.x >> 5) * per_warp) {
    float v[kLnChunks][8];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kLnChunks; ++j) {
      const int c8 = sl + j * L;
      if (c8 < n8) {
        unpack8(*reinterpret_cast<const uint4*>(src + r * lds + c8 * 8), v[j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) sum += v[j][i];
      }
    }
    for (int o = L / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / C;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < kLnChunks; ++j) {
      if (sl + j * L < n8) {
#pragma unroll
        for (int i = 0; i < 8; ++i) sq += (v[j][i] - mean) * (v[j][i] - mean);
      }
    }
    for (int o = L / 2; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float inv = 1.f / sqrtf(sq / C + eps);
#pragma unroll
    for (int j = 0; j < kLnChunks; ++j) {
      const int c8 = sl + j * L;
      if (c8 < n8) {
        float sc[8], bb[8];
        unpack8(*reinterpret_cast<const uint4*>(gs + c8 * 8), sc);
        unpack8(*reinterpret_cast<const uint4*>(bs + c8 * 8), bb);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[j][i] = (v[j][i] - mean) * inv * sc[i] + bb[i];
        *reinterpret_cast<uint4*>(dst + r * ldd + c8 * 8) = pack8(v[j]);
      }
    }
  }
}

// copy_rows, then LN with (gs, bs) in place where gs is given; ends with the
// tile complete for every thread.
__device__ __forceinline__ void load_rows(const Params& p, const Blk& b, const bf16* src,
                                          bool linear, const void* gs, const void* bs,
                                          bf16* dst) {
  copy_rows(p, b, src, linear, dst);
  __syncthreads();
  if (gs == nullptr) return;
  layer_norm_tile(dst, b.lda, dst, b.lda, b.M, p.C, static_cast<const bf16*>(gs),
                  static_cast<const bf16*>(bs), p.eps);
  __syncthreads();
}

// Attention of the block's rows in a0 for its column groups: each warp takes
// the 4 heads of its group in turn, for its 16 query rows of its window.
// put_o(row, col, v): two rounded values of o at block row `row`, block
// column `col` (0 .. groups * 96) and col + 1.
template <typename PutO>
__device__ __forceinline__ void attn_phase(const Params& p, const Blk& b, PutO put_o) {
  const bf16* qkv_w = static_cast<const bf16*>(p.qkv_w);
  const bf16* qkv_b = static_cast<const bf16*>(p.qkv_b);
  const int C = p.C, lane = b.lane, g = b.g, t = b.t;
  const uint32_t a_addr = smem_addr(b.a0 + (b.mt * 16 + (lane & 15)) * b.lda + (lane >> 4) * 8);
  const int wl = b.mt / 4, rw = (b.mt % 4) * 16;  // local window; first row in it
  bf16* ks = b.kv + (wl * b.groups + b.wn) * 2 * kN * kKvLd;
  bf16* vs = ks + kN * kKvLd;
  const int gw = b.win0 + wl;
  const bool valid = gw < b.total;
  const int win = gw % b.nWin;
  const int slab_ld = odd_ld(kQkv * b.groups);
  for (int it = 0; it < kHeads; ++it) {
    const int head = (b.cg0 + b.wn) * kHeads + it;
    // q, k, v of this head for the warp's 16 rows
    float acc[kQkv / 8][4] = {};
    staged_gemm<kQkv / 8>(acc, a_addr, C, b.slab, slab_ld, (kQkv / 8) * b.groups, b.wn * kQkv,
                          3 * C, [&](int k, int c8) {
                            const int grp = c8 / (kQkv / 8), j = c8 % (kQkv / 8);
                            const int hd = (b.cg0 + grp) * kHeads + it;
                            return qkv_w + static_cast<int64_t>(k) * 3 * C + (j / 3) * C +
                                   hd * kD + (j % 3) * 8;
                          });
    uint32_t qa[4], qb[2];
#pragma unroll
    for (int nt = 0; nt < kQkv / 8; ++nt) {
      const int part = nt / 3, j = (nt % 3) * 8 + 2 * t;
      const float2 bv = unpack2(*reinterpret_cast<const uint32_t*>(qkv_b + part * C + head * kD + j));
      const float v0 = rnd<bf16>(acc[nt][0] + bv.x), v1 = rnd<bf16>(acc[nt][1] + bv.y);
      const float v2 = rnd<bf16>(acc[nt][2] + bv.x), v3 = rnd<bf16>(acc[nt][3] + bv.y);
      if (part == 0) {
        const uint32_t lo = pack2(v0 * p.scale, v1 * p.scale);
        const uint32_t hi = pack2(v2 * p.scale, v3 * p.scale);
        if (nt == 0) { qa[0] = lo; qa[1] = hi; }
        if (nt == 1) { qa[2] = lo; qa[3] = hi; }
        if (nt == 2) { qb[0] = lo; qb[1] = hi; }
      } else {
        bf16* dst = part == 1 ? ks : vs;
        *reinterpret_cast<uint32_t*>(dst + (rw + g) * kKvLd + j) = pack2(v0, v1);
        *reinterpret_cast<uint32_t*>(dst + (rw + g + 8) * kKvLd + j) = pack2(v2, v3);
      }
    }
    __syncthreads();  // k, v of the window's 64 rows are in place

    // scores = q k^T: 8 column tiles of 8 keys, depth 24 = 16 + 8
    float s[kN / 8][4] = {};
    const uint32_t k_addr =
        smem_addr(ks + (lane & 7) * kKvLd + ((lane >> 3) < 2 ? (lane >> 3) : 2) * 8);
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
      uint32_t kb[4];
      ldsm_x4(kb, k_addr + nt * 8 * kKvLd * 2);
      mma_k16(s[nt], qa, kb[0], kb[1]);
      mma_k8(s[nt], qb[0], qb[1], kb[2]);
    }
    if (valid) {
      const float* bp =
          p.bias + ((static_cast<int64_t>(win) * p.heads + head) * kN + rw + g) * kN + 2 * t;
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt) {
        const float2 u = *reinterpret_cast<const float2*>(bp + nt * 8);
        const float2 l = *reinterpret_cast<const float2*>(bp + 8 * kN + nt * 8);
        s[nt][0] += u.x; s[nt][1] += u.y; s[nt][2] += l.x; s[nt][3] += l.y;
      }
    }
    // softmax of rows g (values 0, 1) and g + 8 (values 2, 3) over the quad
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mx0); s[nt][1] = expf(s[nt][1] - mx0);
      s[nt][2] = expf(s[nt][2] - mx1); s[nt][3] = expf(s[nt][3] - mx1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

    // o = p v: the rounded p fragments are the A operand; depth 64, width 24
    float o[kD / 8][4] = {};
    const bf16* vrow = vs + (lane & 15) * kKvLd;
#pragma unroll
    for (int j = 0; j < kN / 16; ++j) {
      const uint32_t pa[4] = {pack2(s[2 * j][0] / l0, s[2 * j][1] / l0),
                              pack2(s[2 * j][2] / l1, s[2 * j][3] / l1),
                              pack2(s[2 * j + 1][0] / l0, s[2 * j + 1][1] / l0),
                              pack2(s[2 * j + 1][2] / l1, s[2 * j + 1][3] / l1)};
      uint32_t vb[4], vc[2];
      ldsm_x4_t(vb, smem_addr(vrow + j * 16 * kKvLd + (lane >> 4) * 8));
      ldsm_x2_t(vc, smem_addr(vrow + j * 16 * kKvLd + 16));
      mma_k16(o[0], pa, vb[0], vb[1]);
      mma_k16(o[1], pa, vb[2], vb[3]);
      mma_k16(o[2], pa, vc[0], vc[1]);
    }
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      const int col = b.wn * kGroup + it * kD + nt * 8 + 2 * t;
      put_o(b.mt * 16 + g, col, pack2(o[nt][0], o[nt][1]));
      put_o(b.mt * 16 + g + 8, col, pack2(o[nt][2], o[nt][3]));
    }
    // the next head's product syncs before it overwrites k and v
  }
}

// The keep scale of this warp's window (1 outside train mode).
__device__ __forceinline__ float keep_scale(const float* m, const Blk& b) {
  const int gw = b.win0 + b.mt / 4;
  return (m != nullptr && gw < b.total) ? rnd<bf16>(m[gw / b.nWin]) : 1.f;
}

// Projection of the rows in A (o, [M][lda]) for the block's column groups:
// the attention branch (bias added, rounded, times m1 in train mode) lands in
// `stage` [M][lds], which holds the block's columns. Then, 16 bytes a thread
// over the block's columns: kMlp false, out = the branch (K5); kMlp true, y = x +
// branch into `stage` and, where p.y is given, into y; with `ln2` the row of
// LN2(y) goes to `yn` (the block must hold all columns).
template <bool kMlp>
__device__ __forceinline__ void proj_phase(const Params& p, const Blk& b, const bf16* A,
                                           bf16* stage, int lds, bool ln2, bf16* yn) {
  const bf16* proj_w = static_cast<const bf16*>(p.proj_w);
  const bf16* proj_b = static_cast<const bf16*>(p.proj_b);
  const int C = p.C, lane = b.lane;
  float acc[kGroup / 8][4] = {};
  staged_gemm<kGroup / 8>(
      acc, smem_addr(A + (b.mt * 16 + (lane & 15)) * b.lda + (lane >> 4) * 8), C, b.slab,
      odd_ld(kGroup * b.groups), (kGroup / 8) * b.groups, b.wn * kGroup, C, [&](int k, int c8) {
        return proj_w + static_cast<int64_t>(k) * C + b.cg0 * kGroup + c8 * 8;
      });
  const float m1 = keep_scale(p.m1, b);
  const bool train = p.m1 != nullptr;
#pragma unroll
  for (int nt = 0; nt < kGroup / 8; ++nt) {
    const int col = (b.cg0 + b.wn) * kGroup + nt * 8 + 2 * b.t;
    const float2 bv = unpack2(*reinterpret_cast<const uint32_t*>(proj_b + col));
    float v[4] = {rnd<bf16>(acc[nt][0] + bv.x), rnd<bf16>(acc[nt][1] + bv.y),
                  rnd<bf16>(acc[nt][2] + bv.x), rnd<bf16>(acc[nt][3] + bv.y)};
    if (train) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = m1 * v[i];
    }
    bf16* dst = stage + (b.mt * 16 + b.g) * lds + col - b.cg0 * kGroup;
    *reinterpret_cast<uint32_t*>(dst) = pack2(v[0], v[1]);
    *reinterpret_cast<uint32_t*>(dst + 8 * lds) = pack2(v[2], v[3]);
  }
  __syncthreads();
  const bf16* x = static_cast<const bf16*>(p.x);
  bf16* out = static_cast<bf16*>(p.out);
  bf16* y = static_cast<bf16*>(p.y);
  const int n8 = b.groups * (kGroup / 8), col0 = b.cg0 * kGroup;
  for (int i = threadIdx.x; i < b.M * n8; i += blockDim.x) {
    const int r = i / n8, c = (i - r * n8) * 8;
    const int gw = b.win0 + r / kN;
    if (gw >= b.total) continue;
    const int64_t off = row_offset(p, b.nWin, gw, r % kN) + col0 + c;
    bf16* sp = stage + r * lds + c;
    const uint4 a = *reinterpret_cast<const uint4*>(sp);
    if (!kMlp) {
      *reinterpret_cast<uint4*>(out + off) = a;
      continue;
    }
    float av[8], xv[8];
    unpack8(a, av);
    unpack8(*reinterpret_cast<const uint4*>(x + off), xv);
#pragma unroll
    for (int j = 0; j < 8; ++j) xv[j] += av[j];
    const uint4 yv = pack8(xv);
    *reinterpret_cast<uint4*>(sp) = yv;
    if (y != nullptr) *reinterpret_cast<uint4*>(y + off) = yv;
  }
  if (kMlp && ln2) {
    __syncthreads();
    layer_norm_tile(stage, lds, yn, b.lda, b.M, C, static_cast<const bf16*>(p.ln2_s),
                    static_cast<const bf16*>(p.ln2_b), p.eps);
  }
}

// MLP of the rows whose LN2 is in yn [M][lda], for the block's column groups:
// per hidden chunk of groups * 64 columns, fc1 + GELU into the hidden tile
// (over the k, v tiles), then fc2 into register accumulators; z (bias added,
// rounded, times m2 in train mode) goes through `yn`'s own tile to out = y +
// z, y from y_tile [M][lda] where given, else from p.y.
__device__ __forceinline__ void mlp_phase(const Params& p, const Blk& b, bf16* yn,
                                          const bf16* y_tile) {
  const bf16* fc1_w = static_cast<const bf16*>(p.fc1_w);
  const bf16* fc1_b = static_cast<const bf16*>(p.fc1_b);
  const bf16* fc2_w = static_cast<const bf16*>(p.fc2_w);
  const bf16* fc2_b = static_cast<const bf16*>(p.fc2_b);
  const int C = p.C, hidden = p.hidden, lane = b.lane;
  const int chunk = b.groups * kFc1, ldh = chunk + 8;
  bf16* hbuf = b.kv;
  const int row = b.mt * 16 + (lane & 15);
  const uint32_t yn_addr = smem_addr(yn + row * b.lda + (lane >> 4) * 8);
  const uint32_t h_addr = smem_addr(hbuf + row * ldh + (lane >> 4) * 8);
  float z[kGroup / 8][4] = {};
  for (int h0 = 0; h0 < hidden; h0 += chunk) {
    float f[kFc1 / 8][4] = {};
    staged_gemm<kFc1 / 8>(f, yn_addr, C, b.slab, odd_ld(chunk), chunk / 8, b.wn * kFc1,
                          hidden, [&](int k, int c8) {
                            return fc1_w + static_cast<int64_t>(k) * hidden + h0 + c8 * 8;
                          });
#pragma unroll
    for (int nt = 0; nt < kFc1 / 8; ++nt) {
      const int c = b.wn * kFc1 + nt * 8 + 2 * b.t;
      const float2 bv = unpack2(*reinterpret_cast<const uint32_t*>(fc1_b + h0 + c));
      bf16* dst = hbuf + (b.mt * 16 + b.g) * ldh + c;
      *reinterpret_cast<uint32_t*>(dst) = pack2(gelu(f[nt][0] + bv.x), gelu(f[nt][1] + bv.y));
      *reinterpret_cast<uint32_t*>(dst + 8 * ldh) =
          pack2(gelu(f[nt][2] + bv.x), gelu(f[nt][3] + bv.y));
    }
    __syncthreads();
    staged_gemm<kGroup / 8>(z, h_addr, chunk, b.slab, odd_ld(kGroup * b.groups),
                            (kGroup / 8) * b.groups, b.wn * kGroup, C, [&](int k, int c8) {
                              return fc2_w + static_cast<int64_t>(h0 + k) * C +
                                     b.cg0 * kGroup + c8 * 8;
                            });
  }
  const float m2 = keep_scale(p.m2, b);
  const bool train = p.m2 != nullptr;
#pragma unroll
  for (int nt = 0; nt < kGroup / 8; ++nt) {
    const int col = (b.cg0 + b.wn) * kGroup + nt * 8 + 2 * b.t;
    const float2 bv = unpack2(*reinterpret_cast<const uint32_t*>(fc2_b + col));
    float v[4] = {rnd<bf16>(z[nt][0] + bv.x), rnd<bf16>(z[nt][1] + bv.y),
                  rnd<bf16>(z[nt][2] + bv.x), rnd<bf16>(z[nt][3] + bv.y)};
    if (train) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = m2 * v[i];
    }
    bf16* dst = yn + (b.mt * 16 + b.g) * b.lda + col;
    *reinterpret_cast<uint32_t*>(dst) = pack2(v[0], v[1]);
    *reinterpret_cast<uint32_t*>(dst + 8 * b.lda) = pack2(v[2], v[3]);
  }
  __syncthreads();
  bf16* out = static_cast<bf16*>(p.out);
  const bf16* y = static_cast<const bf16*>(p.y);
  const int n8 = b.groups * (kGroup / 8), col0 = b.cg0 * kGroup;
  for (int i = threadIdx.x; i < b.M * n8; i += blockDim.x) {
    const int r = i / n8, c = col0 + (i - r * n8) * 8;
    const int gw = b.win0 + r / kN;
    if (gw >= b.total) continue;
    const int64_t off = row_offset(p, b.nWin, gw, r % kN) + c;
    float zv[8], yv[8];
    unpack8(*reinterpret_cast<const uint4*>(yn + r * b.lda + c), zv);
    unpack8(y_tile != nullptr ? *reinterpret_cast<const uint4*>(y_tile + r * b.lda + c)
                              : *reinterpret_cast<const uint4*>(y + off), yv);
#pragma unroll
    for (int j = 0; j < 8; ++j) yv[j] += zv[j];
    *reinterpret_cast<uint4*>(out + off) = pack8(yv);
  }
}

// C <= 384: the whole block (kMlp) or the attention half in one kernel, wpb
// windows a block, every column group in the block; o, y and LN2(y) stay in
// shared memory.
template <bool kMlp>
__global__ void __launch_bounds__(kThreads, 1) fused_kernel(Params p, int wpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = wpb * kN, groups = p.C / kGroup;
  const Blk b = make_blk(p, smem, M, 0, blockIdx.x * wpb, smem_layout(M, p.C, groups, p.C, true, kMlp));
  load_rows(p, b, static_cast<const bf16*>(p.x), false, kMlp ? p.ln1_s : nullptr, p.ln1_b, b.a0);
  bf16* o_tile = b.a1;
  const int lda = b.lda;
  attn_phase(p, b, [=](int row, int col, uint32_t v) {
    *reinterpret_cast<uint32_t*>(o_tile + row * lda + col) = v;
  });
  proj_phase<kMlp>(p, b, b.a1, b.a0, b.lda, true, b.a1);
  if (!kMlp) return;
  __syncthreads();
  mlp_phase(p, b, b.a1, b.a0);
}

// C = 768, first of three: LN1 (kLn) and the attention of 4 column groups (16
// heads) of one window; o to the window-major scratch.
template <bool kLn>
__global__ void __launch_bounds__(kThreads, 1) attn_kernel(Params p, bf16* o_scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = (blockDim.x >> 5) / (kN / 16);
  const Blk b = make_blk(p, smem, kN, blockIdx.y * groups, blockIdx.x,
                         smem_layout(kN, p.C, groups, 0, true, false));
  load_rows(p, b, static_cast<const bf16*>(p.x), false, kLn ? p.ln1_s : nullptr, p.ln1_b, b.a0);
  bf16* dst = o_scratch + static_cast<int64_t>(b.win0) * kN * p.C + b.cg0 * kGroup;
  const int C = p.C;
  attn_phase(p, b, [=](int row, int col, uint32_t v) {
    *reinterpret_cast<uint32_t*>(dst + row * C + col) = v;
  });
}

// Second: the projection of one window's rows of o for 4 column groups; K5
// writes out, K3/K7 the residual y.
template <bool kMlp>
__global__ void __launch_bounds__(kThreads, 1) proj_kernel(Params p, const bf16* o_scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = (blockDim.x >> 5) / (kN / 16);
  const Blk b = make_blk(p, smem, kN, blockIdx.y * groups, blockIdx.x,
                         smem_layout(kN, p.C, groups, groups * kGroup, false, false));
  load_rows(p, b, o_scratch, true, nullptr, nullptr, b.a0);
  proj_phase<kMlp>(p, b, b.a0, b.a1, groups * kGroup + 8, false, nullptr);
}

// Third: LN2 and the MLP of one window's rows of y for 4 column groups of
// the output.
__global__ void __launch_bounds__(kThreads, 1) mlp_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = (blockDim.x >> 5) / (kN / 16);
  const Blk b = make_blk(p, smem, kN, blockIdx.y * groups, blockIdx.x,
                         smem_layout(kN, p.C, groups, 0, false, true));
  load_rows(p, b, static_cast<const bf16*>(p.y), false, p.ln2_s, p.ln2_b, b.a0);
  mlp_phase(p, b, b.a0, nullptr);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, int smem, cudaStream_t stream, Args... args) {
  if (smem > smem_limit()) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

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

// The FMA instantiation. dtype: 0 = float32, 1 = bfloat16 (x, out and every
// weight; bias is fp32). mlp: 0 = K5 (attention only), 1 = K3 (whole block); with y, m1 and m2
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
           B, H, W, C, heads, window, shift, hidden, rows, eps, scale, y,
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

// The tensor-core instantiation: bf16, window 8, head dim 24, C = 96 * groups.
// mlp, y, m1, m2 as for swin_window. scratch null: groups <= 4, one kernel
// with wpb windows and wpb * 4 * groups <= 16 warps a block. scratch given
// (o, [B * H * W, C] bf16): groups a multiple of 4, three kernels (two for
// K5) with 4 column groups a block; with mlp, y must be given (the residual
// passes through it). Returns the last launch's cudaGetLastError().
extern "C" int swin_window_tc(int mlp, const void* x, void* out, const void* ln1_s,
                              const void* ln1_b, const void* qkv_w, const void* qkv_b,
                              const void* proj_w, const void* proj_b, const void* ln2_s,
                              const void* ln2_b, const void* fc1_w, const void* fc1_b,
                              const void* fc2_w, const void* fc2_b, const void* bias, int B,
                              int H, int W, int C, int heads, int window, int shift,
                              int hidden, float eps, float scale, void* y, const void* m1,
                              const void* m2, void* scratch, int wpb, void* stream) {
  const int groups = C / tc::kGroup;
  if (window != 8 || H % 8 || W % 8 || C % tc::kGroup || heads * tc::kD != C ||
      (m1 == nullptr) != (m2 == nullptr) || (m1 != nullptr && (!mlp || y == nullptr)) ||
      (y != nullptr && !mlp)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{x, out, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s, ln2_b,
           fc1_w, fc1_b, fc2_w, fc2_b, static_cast<const float*>(bias),
           B, H, W, C, heads, window, shift, hidden, 0, eps, scale, y,
           static_cast<const float*>(m1), static_cast<const float*>(m2)};
  const int total = B * (H / 8) * (W / 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch == nullptr) {
    const int warps = wpb * (tc::kN / 16) * groups;
    // (a slab is at most 32 x 12 * groups chunks for 128 * wpb * groups
    // threads: 3 copies a thread, staged_gemm's kSlabCopies)
    if (wpb < 1 || warps * 32 > tc::kThreads || (mlp && hidden % (groups * tc::kFc1)))
      return static_cast<int>(cudaErrorInvalidValue);
    const int smem = tc::smem_layout(wpb * tc::kN, C, groups, C, true, mlp != 0).total;
    const dim3 grid((total + wpb - 1) / wpb);
    return mlp ? tc::launch(tc::fused_kernel<true>, grid, warps * 32, smem, s, p, wpb)
               : tc::launch(tc::fused_kernel<false>, grid, warps * 32, smem, s, p, wpb);
  }
  constexpr int kSplit = 4;  // column groups a block
  if (groups % kSplit || (mlp && (y == nullptr || hidden % (kSplit * tc::kFc1))))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(total, groups / kSplit);
  const int threads = (tc::kN / 16) * kSplit * 32;
  tc::bf16* o = static_cast<tc::bf16*>(scratch);
  int smem = tc::smem_layout(tc::kN, C, kSplit, 0, true, false).total;
  int rc = mlp ? tc::launch(tc::attn_kernel<true>, grid, threads, smem, s, p, o)
               : tc::launch(tc::attn_kernel<false>, grid, threads, smem, s, p, o);
  if (rc != 0) return rc;
  smem = tc::smem_layout(tc::kN, C, kSplit, kSplit * tc::kGroup, false, false).total;
  const tc::bf16* oc = o;
  rc = mlp ? tc::launch(tc::proj_kernel<true>, grid, threads, smem, s, p, oc)
           : tc::launch(tc::proj_kernel<false>, grid, threads, smem, s, p, oc);
  if (rc != 0 || !mlp) return rc;
  smem = tc::smem_layout(tc::kN, C, kSplit, 0, false, true).total;
  return tc::launch(tc::mlp_kernel, grid, threads, smem, s, p);
}
