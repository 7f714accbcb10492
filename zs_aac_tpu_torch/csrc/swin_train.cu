// Kernels K6, K8 and K9: the backward passes of the train-mode Swin block,
// on x [B, H, W, C] in fp32 or bf16 (weight and bias gradients in fp32).
//
// K6 replaces the Pallas TPU kernel zs_aac_tpu/ops/window_attn.py::
// _bwd_kernel (the backward of window attention, K5), K9 replaces
// ::_attn_ln1_bwd_kernel (the same wrapped in LN1 and the m1-scaled
// residual) and K8 replaces ::_mlp_bwd_kernel (LN2 -> fc1 -> GELU -> fc2 and
// the m2-scaled residual, from the saved post-attention residual y). K7, the
// train forward, lives in window_attn.cu.
//
// Function (the port's window_attention_bwd_plain, attn_ln1_bwd_plain and
// mlp_bwd_plain), with the forward recomputed in the kernel:
//   [K6/K9] go = g (K6) or dy * m1 (K9), rolled by -s and partitioned;
//     do = go Wproj^T; dp = do v^T; ds = p (dp - sum(dp p)); dq = ds k * d^-0.5;
//     dk = ds^T (q d^-0.5); dv = p^T do; dxn = [dq dk dv] Wqkv^T, unrolled;
//     K6: dx = dxn; K9: dx = dy + LN1'(dxn).
//     dWqkv = xn^T dqkv, dbqkv = sum dqkv, dWproj = o^T go, dbproj = sum go,
//     dbias[window, head] = sum over the batch of ds, dLN1 (K9).
//   [K8] gz = g * m2; h = fc1(LN2 y); dh = (gz Wfc2^T) gelu'(h);
//     dy = g + LN2'(dh Wfc1^T); dWfc2 = gelu(h)^T gz, dbfc2 = sum gz,
//     dWfc1 = LN2(y)^T dh, dbfc1 = sum dh, dLN2.
//
// Bound: operations at HTSAT's shapes (about twice the forward's products,
// plus the recomputed forward), like K3's.
//
// Design. The TPU kernels accumulate every weight gradient across a
// sequential grid; here blocks run in parallel, so each kernel is split:
// - a per-window (K6/K9) or per-row-group (K8) kernel does the per-token
//   work as K3 does (K6/K9: blocks over 8x8 windows, the cyclic shift folded
//   into the index arithmetic on x, on the cotangents and on dx alike) and
//   writes the operands of the weight-gradient products (LN'd input, go, o,
//   dqkv; LN2(y), gz, gelu(h), dh) to scratch in the activation dtype,
//   rounded where the TPU kernel rounds them, plus fp32 per-block partials
//   of the small reductions (dbias per batch row, the LN gradients, K8's fc1
//   bias gradient, which sums dh before rounding);
// - dx of K6/K9 comes from a second per-row-group kernel, dqkv Wqkv^T, then
//   K9's LN1 backward and residual;
// - every weight gradient is a hand-written split-token product: each block
//   sums A^T B over one output tile and one chunk of tokens into an fp32
//   partial; a reduction kernel then adds the partials in a fixed order. No
//   atomics: results are deterministic run to run.
//
// Two instantiations of the per-token kernels of K6, K8 and K9 and of the
// split-token product, chosen by shape in ops/window_attn.py::mlp_bwd_plan,
// ::attn_bwd_plan and ::wgrad_plan:
//
// 1. The tensor-core kernels (namespace tc; bf16). K8 at C = 96, 192, 384
//    with hidden = 4C, K9 at C = 96, 192, 384 and K6 at C = 768, both with
//    8x8 windows and head dim 24 (HTSAT's stages 1-3 and 4: every shape the
//    train step gives them); the product where both output dimensions are
//    multiples of 96 (every weight gradient of K6, K8 and K9 at HTSAT's
//    widths).
//    - K8 (mlp_bwd_kernel): the forward's layout (window_attn.cu, namespace
//      tc): a warp owns 16 rows and one column group of 96 channels, a block
//      is 8 warps = (M / 16) x (C / 96) over M = 128, 64 or 32 consecutive
//      tokens. The rows of y and g arrive once, 16 bytes a thread with every
//      copy in flight, and stay in shared memory for the LN2 backward and
//      the residual at the end. Per hidden chunk of 64 * C / 96 columns,
//      three mma.sync products on staged weight slabs (swin_common.cuh::
//      staged_gemm): h = LN2(y) Wfc1 (gelu(h) rounded into a tile, gelu'(h)
//      kept in registers in fp32), e = gz Wfc2^T (dh = e gelu'(h): column
//      sums in fp32 by quad shuffles, then rounded into a tile), dyn += dh
//      Wfc1^T in registers across the chunks (48 a thread). The wrapper
//      passes Wfc2^T and Wfc1^T as copies made once a call, so every product
//      stages rows along its output columns as the forward does. Both hidden
//      tiles leave for scratch 16 bytes a thread along the rows. dyn (fp32)
//      then overlays the operand tiles for the LN2 backward, where a lane
//      also sums its channels of dyn, dyn xhat and gz over its rows: the
//      partials of dLN2 and of the fc2 bias gradient. 32 + 32 + 48
//      accumulators a thread: 256 threads and one block an SM, no spills.
//    - K9, kernel A (attn_bwd_kernel), the forward's layout again: a warp
//      owns 16 query rows and one column group of 96 channels = 4 heads, a
//      block is 8 warps: two windows of one group at C = 96, one window of
//      two groups at C = 192, and at C = 384 a window's four groups split
//      over two blocks (each recomputes LN1 of the window's rows: one
//      window's tiles for four groups would need ~310 KB of shared memory).
//      The rows of x and dy arrive once, 16 bytes a thread; LN1(x) and go =
//      dy m1 go into row tiles (and to scratch), and do = go Wproj^T is one
//      staged product over go's tile (Wproj^T a copy the wrapper makes once
//      a call) whose result lies over go. Per head: qkv recomputed as in the
//      forward, qs kept as A fragments, k, v and qs in bf16 tiles; scores,
//      bias, softmax and the rounded p on the fragments (p stays fp32 in
//      registers); o = rnd(p) v; dp = do v^T; ds = p (dp - rowsum(dp p)) with
//      the row sums by quad shuffles, its fp32 values straight from the
//      fragments to the dbias partial of the batch row; dq = rnd(ds) k. After
//      one barrier on the head's rnd(p) and rnd(ds) tiles [64][72] of all 64
//      rows, a warp takes 16 key rows: dk = rnd(ds)^T qs and dv = rnd(p)^T do,
//      the A fragments of the transposes by ldmatrix.trans. o, dq, dk and dv
//      leave through a per-warp staging tile, 16 bytes a lane. 170 registers,
//      no spills; one block an SM (145 / 158 / 207 KB of shared memory).
//    - K9, kernel B (attn_dx_kernel), K8's form: a warp owns 16 rows and 96
//      output columns over 128 / (C / 96) window-major scratch rows; dxn =
//      dqkv Wqkv^T (K = 3C; Wqkv^T a copy made once a call) in registers,
//      rounded into an fp32 tile over the dqkv rows, then the LN1 backward
//      with the statistics recomputed from x, dx written at the tokens'
//      places. C / 24 lanes take a row, 3 chunks of 8 channels a lane. It also
//      sums go and dqkv over its rows: the partials of the proj and qkv bias
//      gradients come with dLN1's, and no column-sum launch is left.
//    - K6 (attn_bwd_kernel<false>, attn_dx_kernel<false>): K9's kernels
//      with xn = x and go = g. At C = 768 a window's eight column groups go
//      over four blocks of two (256 blocks of 8 warps for 64 windows). K9's
//      layout, a row tile each for LN1(x) and go, would need 305,664 bytes
//      of shared memory there; K6 keeps one row tile: g's rows arrive first,
//      do = g Wproj^T for the block's 192 columns goes to a [64][200] tile,
//      then x's rows arrive over g's (231,936 of the 232,448 bytes a block
//      may take; attn_smem). Kernel B takes 16 rows a block (one per warp
//      row, 8 column groups); its dx needs no LN backward and goes out as
//      bf16 through a tile over the dqkv rows (222,976 bytes; dx_smem); it
//      sums g (read at the tokens' places) and dqkv over its rows for the
//      bias gradients. Stage 4 at B = 64 (NVIDIA H100 80GB HBM3, 700.00 W;
//      examples/probe_window_kernels.py --train): kernel A 238 us, kernel B
//      287 us (each block stages all of Wqkv^T for its 16 rows), the two
//      weight products 165 us, the reductions 28 us: 704 us in all; with
//      --fma, every part on the FMA kernels, 13.0 ms.
//    - The product (tc::wgrad_kernel): tokens are the k direction. 96 x 96
//      output tiles (they divide every width: nothing is padded), 4 warps of
//      48 x 48, both operands' tiles [32 tokens][96 columns] through three
//      shared-memory buffers by 16-byte cp.async (zeros past the chunk's
//      end), and both fragments by ldmatrix.trans: A's tile is [k][m], so
//      its transpose is the row-major A operand. At HTSAT's shapes it runs
//      at the rate the scratch can be read at.
// 2. The FMA kernels (attn_bwd_a, attn_bwd_b, mlp_bwd_a, wgrad_kernel;
//    fp32, whose fixtures TF32 would break, bf16 at other widths, and the
//    column sums of the FMA route, which are bound by bytes): fp32
//    channel-major shared tiles, 64 x 64 output tiles, CUDA-core FMAs through
//    block_gemm, one head at a time; per-head buffers stay under the
//    shared-memory limit up to C=768 in bf16 and C=384 in fp32.
//
// Numerics (the JAX kernels' rounding points): in the activation dtype T
// these round: go, qkv, qs, p (for o and dv), o, do, ds (for dq and dk), dq
// (then dq * scale), dk, dv, dxn, gz, gelu(h), dh, the LN outputs and dx;
// softmax, ds for dbias, dp, LN statistics and every sum stay fp32. GELU and
// its derivative and the softmax's expf are exact (no fast math).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC.

#include "swin_common.cuh"

namespace {

using namespace swin;

struct AttnBwd {
  const void *x, *g, *ln1_s, *ln1_b, *qkv_w, *qkv_b, *proj_w;
  const float *m1, *bias;
  void *dx, *xn_s, *go_s, *o_s, *do_s, *dqkv_s;
  float *dbias_part, *ln_part;
  int H, W, C, heads, window, shift, rows;
  float eps, scale;
};

struct MlpBwd {
  const void *y, *g, *ln2_s, *ln2_b, *fc1_w, *fc1_b, *fc2_w;
  const float* m2;
  void *dy, *yn_s, *gz_s, *hg_s, *dh1_s;
  float *ln_part, *fc1b_part;
  int HW, C, hidden, rows;
  float eps;
};

// Shared memory of the per-window attention kernel: per-head fp32 buffers
//   qT, kT, doT [d][N+kPad]; qR, v, doR [N][d]; pT, prT, dsT [N][N+kPad]
// then the window's input xa [C][N+kPad] in T.
__host__ __device__ inline int attn_a_smem(int itemsize, int N, int C, int d) {
  const int ld = N + kPad;
  return align16(4 * (3 * d * ld + 3 * N * d + 3 * N * ld)) + align16(itemsize * C * ld);
}
// dx kernel: acc [C][R+kPad] and a chunk [kChunk][R+kPad] in fp32, mean/inv [R].
__host__ __device__ inline int attn_b_smem(int C, int R) {
  const int ld = R + kPad;
  return align16(4 * (C * ld + kChunk * ld + 2 * R));
}
// MLP kernel: acc [C][R+kPad], hm and dh [kChunk][R+kPad], mean/inv [R] in
// fp32; yn and gz [C][R+kPad] in T.
__host__ __device__ inline int mlp_a_smem(int itemsize, int C, int R) {
  const int ld = R + kPad;
  return align16(4 * (C * ld + 2 * kChunk * ld + 2 * R)) + 2 * align16(itemsize * C * ld);
}

// Element offset of channel 0 of token r of rolled-frame window `win` of
// batch row b (shift folded into the index).
__device__ __forceinline__ int64_t tok_offset(int b, int win, int r, int H, int W, int C, int w,
                                              int s) {
  const int nW = W / w, wi = win / nW, wj = win % nW;
  const int hr = (wi * w + r / w + s) % H;
  const int wc = (wj * w + r % w + s) % W;
  return ((static_cast<int64_t>(b) * H + hr) * W + wc) * C;
}

// Mean and 1/sigma of one row (a warp).
template <typename T>
__device__ __forceinline__ void row_stats(const T* row, int C, float eps, int lane, float& mean,
                                          float& inv) {
  float sum = 0.f;
  for (int c = lane; c < C; c += 32) sum += ld(row + c);
  mean = warp_sum(sum) / C;
  float sq = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float dv = ld(row + c) - mean;
    sq += dv * dv;
  }
  inv = 1.f / sqrtf(warp_sum(sq) / C + eps);
}

// Per window: go, do, the recomputed attention and dq/dk/dv per head, the
// dbias partial; scratch rows are indexed blk * N + r (blk = b * nWin + win).
template <typename T, bool kLn>
__global__ void __launch_bounds__(kMaxThreads) attn_bwd_a(AttnBwd p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, W = p.W, C = p.C, w = p.window, s = p.shift, h = p.heads;
  const int N = w * w, d = C / h, ldn = N + kPad, C3 = 3 * C;
  const int nWin = (H / w) * (W / w);
  const int blk = blockIdx.x, win = blk % nWin, b = blk / nWin;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const T* x = static_cast<const T*>(p.x);
  const T* g = static_cast<const T*>(p.g);
  T* xn_s = static_cast<T*>(p.xn_s);
  T* go_s = static_cast<T*>(p.go_s);
  T* o_s = static_cast<T*>(p.o_s);
  T* do_s = static_cast<T*>(p.do_s);
  T* dqkv_s = static_cast<T*>(p.dqkv_s);
  const int64_t row0 = static_cast<int64_t>(blk) * N;
  auto tok = [&](int r) { return tok_offset(b, win, r, H, W, C, w, s); };

  float* qT = reinterpret_cast<float*>(smem);
  float* kT = qT + d * ldn;
  float* doT = kT + d * ldn;
  float* qR = doT + d * ldn;
  float* v = qR + N * d;
  float* doR = v + N * d;
  float* pT = doR + N * d;
  float* prT = pT + N * ldn;
  float* dsT = prT + N * ldn;
  T* xa = reinterpret_cast<T*>(smem + align16(4 * (3 * d * ldn + 3 * N * d + 3 * N * ldn)));

  // 1. go (K9: dy * m1, rounded) channel-major in xa, and to scratch.
  const float m1 = kLn ? rnd<T>(p.m1[b]) : 1.f;
  for (int r = warp; r < N; r += nwarps) {
    const int64_t o = tok(r);
    for (int c = lane; c < C; c += 32) {
      float gv = ld(g + o + c);
      if (kLn) gv = rnd<T>(gv * m1);
      xa[c * ldn + r] = to_t<T>(gv);
      go_s[(row0 + r) * C + c] = to_t<T>(gv);
    }
  }
  __syncthreads();
  // 2. do = go Wproj^T, to scratch.
  const T* proj_w = static_cast<const T*>(p.proj_w);
  block_gemm(xa, ldn, proj_w, 1, C, N, C, [&](int c) { return static_cast<int64_t>(c) * C; },
             [&](int r0, int c, const float* acc) {
#pragma unroll
               for (int i = 0; i < 8; ++i) do_s[(row0 + r0 + i) * C + c] = to_t<T>(acc[i]);
             });
  __syncthreads();
  // 3. The window's input (LN1 of it for K9), channel-major in xa, and to scratch.
  for (int r = warp; r < N; r += nwarps) {
    const T* row = x + tok(r);
    float mean = 0.f, inv = 1.f;
    if (kLn) row_stats(row, C, p.eps, lane, mean, inv);
    const T* gs = static_cast<const T*>(p.ln1_s);
    const T* bs = static_cast<const T*>(p.ln1_b);
    for (int c = lane; c < C; c += 32) {
      const T val = kLn ? to_t<T>((ld(row + c) - mean) * inv * ld(gs + c) + ld(bs + c)) : row[c];
      xa[c * ldn + r] = val;
      xn_s[(row0 + r) * C + c] = val;
    }
  }
  __syncthreads();

  // 4. One head at a time.
  const T* qkv_w = static_cast<const T*>(p.qkv_w);
  const T* qkv_b = static_cast<const T*>(p.qkv_b);
  for (int hh = 0; hh < h; ++hh) {
    block_gemm(xa, ldn, qkv_w, C3, C, N, 3 * d,
               [&](int vc) { return (vc / d) * C + hh * d + vc % d; },
               [&](int r0, int vc, const float* acc) {
                 const int part = vc / d, j = vc % d;
                 const float bv = ld(qkv_b + part * C + hh * d + j);
#pragma unroll
                 for (int i = 0; i < 8; ++i) {
                   const float val = rnd<T>(acc[i] + bv);
                   const int r = r0 + i;
                   if (part == 0) {
                     const float qs = rnd<T>(val * p.scale);
                     qT[j * ldn + r] = qs;
                     qR[r * d + j] = qs;
                   } else if (part == 1) {
                     kT[j * ldn + r] = val;
                   } else {
                     v[r * d + j] = val;
                   }
                 }
               });
    __syncthreads();
    const float* bias = p.bias + ((static_cast<int64_t>(win) * h + hh) * N) * N;
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
      for (int t = 0; t < N; ++t) {
        const float pv = pT[t * ldn + r] / sum;
        pT[t * ldn + r] = pv;
        prT[t * ldn + r] = rnd<T>(pv);
      }
    }
    for (int idx = threadIdx.x; idx < N * d; idx += blockDim.x) {
      const int r = idx / d, j = idx % d;
      const float val = ld(do_s + (row0 + r) * C + hh * d + j);
      doT[j * ldn + r] = val;
      doR[r * d + j] = val;
    }
    __syncthreads();
    // o_h = p v (for dWproj), dp = do v^T
    block_gemm(prT, ldn, v, d, N, N, d, [](int c) { return c; },
               [&](int r0, int j, const float* acc) {
#pragma unroll
                 for (int i = 0; i < 8; ++i)
                   o_s[(row0 + r0 + i) * C + hh * d + j] = to_t<T>(acc[i]);
               });
    block_gemm(doT, ldn, v, 1, d, N, N, [&](int t) { return t * d; },
               [&](int r0, int t, const float* acc) {
#pragma unroll
                 for (int i = 0; i < 8; ++i) dsT[t * ldn + r0 + i] = acc[i];
               });
    __syncthreads();
    // ds = p (dp - sum(dp p)) in fp32 -> dbias partial; rounded for dq/dk
    float* dbias = p.dbias_part + ((static_cast<int64_t>(blk) * h + hh) * N) * N;
    for (int r = threadIdx.x; r < N; r += blockDim.x) {
      float sum = 0.f;
      for (int t = 0; t < N; ++t) sum += dsT[t * ldn + r] * pT[t * ldn + r];
      for (int t = 0; t < N; ++t) {
        const float ds = pT[t * ldn + r] * (dsT[t * ldn + r] - sum);
        dbias[r * N + t] = ds;
        dsT[t * ldn + r] = rnd<T>(ds);
      }
    }
    __syncthreads();
    // dq = (ds k) * scale; dk^T = qs^T ds; dv^T = do^T p
    block_gemm(dsT, ldn, kT, 1, N, N, d, [&](int j) { return j * ldn; },
               [&](int r0, int j, const float* acc) {
#pragma unroll
                 for (int i = 0; i < 8; ++i)
                   dqkv_s[(row0 + r0 + i) * C3 + hh * d + j] =
                       to_t<T>(rnd<T>(rnd<T>(acc[i]) * p.scale));
               });
    block_gemm(qR, d, dsT, 1, N, d, N, [&](int t) { return t * ldn; },
               [&](int j0, int t, const float* acc) {
#pragma unroll
                 for (int i = 0; i < 8; ++i)
                   dqkv_s[(row0 + t) * C3 + C + hh * d + j0 + i] = to_t<T>(acc[i]);
               });
    block_gemm(doR, d, prT, 1, N, d, N, [&](int t) { return t * ldn; },
               [&](int j0, int t, const float* acc) {
#pragma unroll
                 for (int i = 0; i < 8; ++i)
                   dqkv_s[(row0 + t) * C3 + 2 * C + hh * d + j0 + i] = to_t<T>(acc[i]);
               });
    __syncthreads();
  }
}

// Per group of R scratch rows (one window's tokens or part of them):
// dxn = dqkv Wqkv^T, then K6: dx = dxn; K9: dx = dy + LN1'(dxn) and the LN1
// gradient partials. dx is written at the tokens' unrolled positions.
template <typename T, bool kLn>
__global__ void __launch_bounds__(kMaxThreads) attn_bwd_b(AttnBwd p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, W = p.W, C = p.C, w = p.window, s = p.shift, R = p.rows;
  const int N = w * w, ldr = R + kPad, C3 = 3 * C;
  const int nWin = (H / w) * (W / w);
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * R;
  const int blk = static_cast<int>(t0 / N), rbase = static_cast<int>(t0 % N);
  const int win = blk % nWin, b = blk / nWin;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const T* dqkv_s = static_cast<const T*>(p.dqkv_s);
  const T* qkv_w = static_cast<const T*>(p.qkv_w);
  T* dx = static_cast<T*>(p.dx);
  auto tok = [&](int r) { return tok_offset(b, win, rbase + r, H, W, C, w, s); };

  float* acc = reinterpret_cast<float*>(smem);
  float* ach = acc + C * ldr;
  float* mean = ach + kChunk * ldr;
  float* inv = mean + R;
  for (int idx = threadIdx.x; idx < C * ldr; idx += blockDim.x) acc[idx] = 0.f;
  for (int k0 = 0; k0 < C3; k0 += kChunk) {
    const int kc = min(kChunk, C3 - k0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < R * kc; idx += blockDim.x) {
      const int r = idx / kc, kk = idx % kc;
      ach[kk * ldr + r] = ld(dqkv_s + (t0 + r) * C3 + k0 + kk);
    }
    __syncthreads();
    block_gemm(ach, ldr, qkv_w, 1, kc, R, C,
               [&](int c) { return static_cast<int64_t>(c) * C3 + k0; },
               [&](int r0, int c, const float* a) {
#pragma unroll
                 for (int i = 0; i < 8; ++i) acc[c * ldr + r0 + i] += a[i];
               });
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < C * R; idx += blockDim.x) {
    const int c = idx / R, r = idx % R;
    acc[c * ldr + r] = rnd<T>(acc[c * ldr + r]);
  }
  __syncthreads();
  if (!kLn) {
    for (int idx = threadIdx.x; idx < R * C; idx += blockDim.x) {
      const int r = idx / C, c = idx % C;
      dx[tok(r) + c] = to_t<T>(acc[c * ldr + r]);
    }
    return;
  }
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.g);
  const T* ln_s = static_cast<const T*>(p.ln1_s);
  for (int r = warp; r < R; r += nwarps) {
    const int64_t o = tok(r);
    float mu, iv;
    row_stats(x + o, C, p.eps, lane, mu, iv);
    float sa = 0.f, sb = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float gs = acc[c * ldr + r] * ld(ln_s + c);
      sa += gs;
      sb += gs * (ld(x + o + c) - mu) * iv;
    }
    const float ma = warp_sum(sa) / C, mb = warp_sum(sb) / C;
    for (int c = lane; c < C; c += 32) {
      const float xhat = (ld(x + o + c) - mu) * iv;
      const float du = (acc[c * ldr + r] * ld(ln_s + c) - ma - xhat * mb) * iv;
      dx[o + c] = to_t<T>(ld(dy + o + c) + rnd<T>(du));
    }
    if (lane == 0) {
      mean[r] = mu;
      inv[r] = iv;
    }
  }
  __syncthreads();
  float* part = p.ln_part + static_cast<int64_t>(blockIdx.x) * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < R; ++r) {
      const float gv = acc[c * ldr + r];
      s1 += gv * (ld(x + tok(r) + c) - mean[r]) * inv[r];
      s2 += gv;
    }
    part[c] = s1;
    part[C + c] = s2;
  }
}

// Per group of R tokens (natural order): K8.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) mlp_bwd_a(MlpBwd p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = p.C, R = p.rows, hidden = p.hidden, ldr = R + kPad;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const T* y = static_cast<const T*>(p.y);
  const T* g = static_cast<const T*>(p.g);
  const T* ln_s = static_cast<const T*>(p.ln2_s);
  const T* ln_b = static_cast<const T*>(p.ln2_b);
  const T* fc1_w = static_cast<const T*>(p.fc1_w);
  const T* fc1_b = static_cast<const T*>(p.fc1_b);
  const T* fc2_w = static_cast<const T*>(p.fc2_w);
  T* yn_s = static_cast<T*>(p.yn_s);
  T* gz_s = static_cast<T*>(p.gz_s);
  T* hg_s = static_cast<T*>(p.hg_s);
  T* dh1_s = static_cast<T*>(p.dh1_s);

  float* acc = reinterpret_cast<float*>(smem);
  float* hm = acc + C * ldr;
  float* dh = hm + kChunk * ldr;
  float* mean = dh + kChunk * ldr;
  float* inv = mean + R;
  T* yn = reinterpret_cast<T*>(smem + align16(4 * (C * ldr + 2 * kChunk * ldr + 2 * R)));
  T* gz = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(yn) + align16(sizeof(T) * C * ldr));

  for (int r = warp; r < R; r += nwarps) {
    const int64_t o = (t0 + r) * C;
    float mu, iv;
    row_stats(y + o, C, p.eps, lane, mu, iv);
    const float m2 = p.m2[(t0 + r) / p.HW];
    for (int c = lane; c < C; c += 32) {
      const T vn = to_t<T>((ld(y + o + c) - mu) * iv * ld(ln_s + c) + ld(ln_b + c));
      yn[c * ldr + r] = vn;
      yn_s[o + c] = vn;
      const T vz = to_t<T>(ld(g + o + c) * m2);
      gz[c * ldr + r] = vz;
      gz_s[o + c] = vz;
    }
    if (lane == 0) {
      mean[r] = mu;
      inv[r] = iv;
    }
  }
  for (int idx = threadIdx.x; idx < C * ldr; idx += blockDim.x) acc[idx] = 0.f;
  __syncthreads();

  for (int h0 = 0; h0 < hidden; h0 += kChunk) {
    const int hc = min(kChunk, hidden - h0);
    block_gemm(yn, ldr, fc1_w, hidden, C, R, hc, [&](int c) { return h0 + c; },
               [&](int r0, int c, const float* a) {
                 const float bv = ld(fc1_b + h0 + c);
#pragma unroll
                 for (int i = 0; i < 8; ++i) {
                   const float hv = a[i] + bv;
                   hm[c * ldr + r0 + i] = hv;
                   hg_s[(t0 + r0 + i) * hidden + h0 + c] = to_t<T>(gelu(hv));
                 }
               });
    __syncthreads();
    block_gemm(gz, ldr, fc2_w, 1, C, R, hc,
               [&](int j) { return static_cast<int64_t>(h0 + j) * C; },
               [&](int r0, int j, const float* a) {
#pragma unroll
                 for (int i = 0; i < 8; ++i) {
                   const float d1 = a[i] * gelu_grad(hm[j * ldr + r0 + i]);
                   hm[j * ldr + r0 + i] = d1;
                   dh[j * ldr + r0 + i] = rnd<T>(d1);
                   dh1_s[(t0 + r0 + i) * hidden + h0 + j] = to_t<T>(d1);
                 }
               });
    __syncthreads();
    for (int j = threadIdx.x; j < hc; j += blockDim.x) {
      float sum = 0.f;
      for (int r = 0; r < R; ++r) sum += hm[j * ldr + r];
      p.fc1b_part[static_cast<int64_t>(blockIdx.x) * hidden + h0 + j] = sum;
    }
    block_gemm(dh, ldr, fc1_w, 1, hc, R, C,
               [&](int c) { return static_cast<int64_t>(c) * hidden + h0; },
               [&](int r0, int c, const float* a) {
#pragma unroll
                 for (int i = 0; i < 8; ++i) acc[c * ldr + r0 + i] += a[i];
               });
    __syncthreads();
  }

  T* dy = static_cast<T*>(p.dy);
  for (int r = warp; r < R; r += nwarps) {
    const int64_t o = (t0 + r) * C;
    const float mu = mean[r], iv = inv[r];
    float sa = 0.f, sb = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float gs = acc[c * ldr + r] * ld(ln_s + c);
      sa += gs;
      sb += gs * (ld(y + o + c) - mu) * iv;
    }
    const float ma = warp_sum(sa) / C, mb = warp_sum(sb) / C;
    for (int c = lane; c < C; c += 32) {
      const float xhat = (ld(y + o + c) - mu) * iv;
      const float du = (acc[c * ldr + r] * ld(ln_s + c) - ma - xhat * mb) * iv;
      dy[o + c] = to_t<T>(ld(g + o + c) + rnd<T>(du));
    }
  }
  float* part = p.ln_part + static_cast<int64_t>(blockIdx.x) * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < R; ++r) {
      const float gv = acc[c * ldr + r];
      s1 += gv * (ld(y + (t0 + r) * C + c) - mean[r]) * inv[r];
      s2 += gv;
    }
    part[c] = s1;
    part[C + c] = s2;
  }
}

// part[z][i][j] = sum over tokens t of chunk z of A[t][i] * B[t][j] (A null:
// a column of ones, M = 1). 256 threads, a 64x64 output tile, 4x4 a thread.
constexpr int kTile = 64, kTk = 32;

template <typename T>
__global__ void __launch_bounds__(256) wgrad_kernel(const T* A, int lda, const T* B, int ldb,
                                                    int64_t n_tok, int M, int Ncol,
                                                    int64_t chunk_len, float* part) {
  __shared__ __align__(16) float As[kTk][kTile];
  __shared__ __align__(16) float Bs[kTk][kTile];
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int64_t ta = blockIdx.z * chunk_len;
  const int64_t tb = min(n_tok, ta + chunk_len);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4] = {};
  for (int64_t t0 = ta; t0 < tb; t0 += kTk) {
    for (int idx = threadIdx.x; idx < kTk * kTile; idx += 256) {
      const int tt = idx / kTile, k = idx % kTile;
      const int64_t t = t0 + tt;
      const bool in_t = t < tb;
      const int i = i0 + k, j = j0 + k;
      As[tt][k] = (in_t && i < M) ? (A ? ld(A + t * lda + i) : 1.f) : 0.f;
      Bs[tt][k] = (in_t && j < Ncol) ? ld(B + t * ldb + j) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int tt = 0; tt < kTk; ++tt) {
      const float4 a = *reinterpret_cast<const float4*>(&As[tt][ty * 4]);
      const float4 bq = *reinterpret_cast<const float4*>(&Bs[tt][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[u][q] = fmaf(av[u], bv[q], acc[u][q]);
    }
    __syncthreads();
  }
  float* out = part + static_cast<int64_t>(blockIdx.z) * M * Ncol;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ty * 4 + u;
    if (i >= M) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx * 4 + q;
      if (j < Ncol) out[static_cast<int64_t>(i) * Ncol + j] = acc[u][q];
    }
  }
}

// out[j] = sum over z < n_parts of part[z * len + j], in a fixed order: 32
// columns a block, 8 slices of the parts each summed in order, then the 8
// slice sums in order.
__global__ void __launch_bounds__(256) reduce_kernel(const float* part, int n_parts, int64_t len,
                                                     float* out) {
  __shared__ float red[8][32];
  const int64_t j = static_cast<int64_t>(blockIdx.x) * 32 + (threadIdx.x & 31);
  const int slice = threadIdx.x >> 5;
  float sum = 0.f;
  if (j < len)
    for (int z = slice; z < n_parts; z += 8) sum += part[static_cast<int64_t>(z) * len + j];
  red[slice][threadIdx.x & 31] = sum;
  __syncthreads();
  if (slice == 0 && j < len) {
    float tot = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) tot += red[q][threadIdx.x];
    out[j] = tot;
  }
}

// -- the tensor-core kernels (bf16) ------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kGroup = 96;     // channels per warp column group
constexpr int kFc1 = 64;       // hidden columns per warp and chunk
constexpr int kThreads = 256;  // K8, K9: 8 warps = (rows / 16) x (column groups)
constexpr int kRows = 128;     // K8, K9's dx kernel: rows a block times column groups
constexpr int kCopies = 6;     // K8, K9's dx kernel: a 32 x 392 slab over 256 threads
constexpr int kLnChunks = 2;   // K8: 8-channel chunks a lane holds of a row: C <= 512

struct MlpBwdTc {
  const bf16 *y, *g, *ln2_s, *ln2_b, *fc1_w, *fc1_b, *fc2_wt, *fc1_wt;
  const float* m2;
  bf16 *dy, *yn_s, *gz_s, *hg_s, *dh1_s;
  float *ln_part, *fc1b_part;
  int64_t n_tok;
  int HW, C, hidden, rows;
  float eps;
};

// Byte offsets of K8's shared memory: the bf16 row tiles [M][C + 8] of y (at
// 0) and g, which stay for the whole kernel, and of yn and gz, over both of
// which the fp32 dyn tile [M][C + 8] lies after the products; the hidden
// tiles hg and dh [M][chunk + 8] (chunk = 64 * C / 96); the slab buffers
// [3][32][C + 8], over which the gradient partials [row groups][3][C] lie at
// the end; the column sums of dh per row tile [M / 16][chunk]; mean and
// 1/sigma of the rows.
struct MlpSmem {
  int g, yn, gz, hg, dh, slab, colsum, stats, total;
};
__host__ __device__ inline MlpSmem mlp_smem(int M, int C) {
  const int chunk = (C / kGroup) * kFc1, tile = M * (C + 8) * 2, htile = M * (chunk + 8) * 2;
  MlpSmem s;
  s.g = tile;
  s.yn = 2 * tile;
  s.gz = 3 * tile;
  s.hg = 4 * tile;
  s.dh = s.hg + htile;
  s.slab = s.dh + htile;
  s.colsum = s.slab + kSlabStages * kSlabRows * (C + 8) * 2;
  s.stats = s.colsum + (M / 16) * chunk * 4;
  s.total = s.stats + 2 * M * 4;
  return s;
}

// K8 per block of M = p.rows consecutive tokens. A warp owns 16 rows and one
// column group: 96 channels of the C-wide products, 64 columns of a hidden
// chunk.
__global__ void __launch_bounds__(kThreads, 1) mlp_bwd_kernel(MlpBwdTc p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = p.C, hidden = p.hidden, M = p.rows, groups = C / kGroup;
  const int chunk = groups * kFc1, lda = C + 8, ldh = chunk + 8;
  const MlpSmem lay = mlp_smem(M, C);
  bf16* yt = reinterpret_cast<bf16*>(smem);
  bf16* gt = reinterpret_cast<bf16*>(smem + lay.g);
  bf16* yn = reinterpret_cast<bf16*>(smem + lay.yn);
  bf16* gz = reinterpret_cast<bf16*>(smem + lay.gz);
  bf16* hg = reinterpret_cast<bf16*>(smem + lay.hg);
  bf16* dh = reinterpret_cast<bf16*>(smem + lay.dh);
  bf16* slab = reinterpret_cast<bf16*>(smem + lay.slab);
  float* colsum = reinterpret_cast<float*>(smem + lay.colsum);
  float* mean = reinterpret_cast<float*>(smem + lay.stats);
  float* inv = mean + M;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int mt = warp % (M / 16), wn = warp / (M / 16);
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * M;
  // row passes: 16 lanes a row at C <= 128, else a warp; a lane holds the
  // 8-channel chunks sl, sl + L, ... of its row
  const int n8 = C / 8, L = n8 <= 16 ? 16 : 32, sl = lane & (L - 1);
  const int row_groups = (kThreads / 32) * (32 / L), rg = warp * (32 / L) + lane / L;

  // 1. The rows of y and g into their tiles, 16 bytes a thread with every
  // copy in flight at once (rows past the last token: zeros); then LN2(y) and
  // gz = g * m2 into the operand tiles and to scratch.
  for (int i = threadIdx.x; i < M * n8; i += kThreads) {
    const int r = i / n8, c = (i - r * n8) * 8;
    const bool valid = t0 + r < p.n_tok;
    const int64_t off = (valid ? t0 + r : 0) * C + c;
    cp_async16_zfill(yt + r * lda + c, p.y + off, valid);
    cp_async16_zfill(gt + r * lda + c, p.g + off, valid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int r = rg; r < M; r += row_groups) {
    const int64_t tok = t0 + r;
    const bool valid = tok < p.n_tok;
    float v[kLnChunks][8];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kLnChunks; ++j) {
      const int c8 = sl + j * L;
      if (c8 < n8) {
        unpack8(*reinterpret_cast<const uint4*>(yt + r * lda + c8 * 8), v[j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) sum += v[j][i];
      }
    }
    for (int o = L / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mu = sum / C;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < kLnChunks; ++j) {
      if (sl + j * L < n8) {
#pragma unroll
        for (int i = 0; i < 8; ++i) sq += (v[j][i] - mu) * (v[j][i] - mu);
      }
    }
    for (int o = L / 2; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float iv = 1.f / sqrtf(sq / C + p.eps);
    const float m2 = valid ? p.m2[tok / p.HW] : 0.f;
#pragma unroll
    for (int j = 0; j < kLnChunks; ++j) {
      const int c8 = sl + j * L;
      if (c8 < n8) {
        float sc[8], bb[8], gv[8];
        unpack8(*reinterpret_cast<const uint4*>(p.ln2_s + c8 * 8), sc);
        unpack8(*reinterpret_cast<const uint4*>(p.ln2_b + c8 * 8), bb);
        unpack8(*reinterpret_cast<const uint4*>(gt + r * lda + c8 * 8), gv);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          v[j][i] = (v[j][i] - mu) * iv * sc[i] + bb[i];
          gv[i] *= m2;
        }
        const uint4 yv = pack8(v[j]), zv = pack8(gv);
        *reinterpret_cast<uint4*>(yn + r * lda + c8 * 8) = yv;
        *reinterpret_cast<uint4*>(gz + r * lda + c8 * 8) = zv;
        if (valid) {
          *reinterpret_cast<uint4*>(p.yn_s + tok * C + c8 * 8) = yv;
          *reinterpret_cast<uint4*>(p.gz_s + tok * C + c8 * 8) = zv;
        }
      }
    }
    if (sl == 0) {
      mean[r] = mu;
      inv[r] = iv;
    }
  }
  __syncthreads();

  // 2. Per hidden chunk: h and gelu'(h); dh = (gz Wfc2^T) gelu'(h); dyn += dh Wfc1^T.
  const int row = mt * 16 + (lane & 15);
  const uint32_t yn_addr = smem_addr(yn + row * lda + (lane >> 4) * 8);
  const uint32_t gz_addr = smem_addr(gz + row * lda + (lane >> 4) * 8);
  const uint32_t dh_addr = smem_addr(dh + row * ldh + (lane >> 4) * 8);
  float dyn[kGroup / 8][4] = {};
  for (int h0 = 0; h0 < hidden; h0 += chunk) {
    float f[kFc1 / 8][4] = {};
    staged_gemm<kFc1 / 8, kCopies>(f, yn_addr, C, slab, odd_ld(chunk), chunk / 8, wn * kFc1,
                                   hidden, [&](int k, int c8) {
                                     return p.fc1_w + static_cast<int64_t>(k) * hidden + h0 +
                                            c8 * 8;
                                   });
    // gelu(h), rounded, into its tile; gelu'(h) stays in f
#pragma unroll
    for (int nt = 0; nt < kFc1 / 8; ++nt) {
      const int cl = wn * kFc1 + nt * 8 + 2 * t;
      const float2 bv = unpack2(*reinterpret_cast<const uint32_t*>(p.fc1_b + h0 + cl));
      float hv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = f[nt][i] + ((i & 1) ? bv.y : bv.x);
        hv[i] = gelu(x);
        f[nt][i] = gelu_grad(x);
      }
      bf16* dst = hg + (mt * 16 + g) * ldh + cl;
      *reinterpret_cast<uint32_t*>(dst) = pack2(hv[0], hv[1]);
      *reinterpret_cast<uint32_t*>(dst + 8 * ldh) = pack2(hv[2], hv[3]);
    }
    float e[kFc1 / 8][4] = {};
    staged_gemm<kFc1 / 8, kCopies>(e, gz_addr, C, slab, odd_ld(chunk), chunk / 8, wn * kFc1,
                                   hidden, [&](int k, int c8) {
                                     return p.fc2_wt + static_cast<int64_t>(k) * hidden + h0 +
                                            c8 * 8;
                                   });
    // dh in fp32: its column sums over the warp's 16 rows; rounded, into its tile
#pragma unroll
    for (int nt = 0; nt < kFc1 / 8; ++nt) {
      const int cl = wn * kFc1 + nt * 8 + 2 * t;
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = e[nt][i] * f[nt][i];
      float s0 = d[0] + d[2], s1 = d[1] + d[3];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (g == 0) *reinterpret_cast<float2*>(colsum + mt * chunk + cl) = make_float2(s0, s1);
      bf16* dst = dh + (mt * 16 + g) * ldh + cl;
      *reinterpret_cast<uint32_t*>(dst) = pack2(d[0], d[1]);
      *reinterpret_cast<uint32_t*>(dst + 8 * ldh) = pack2(d[2], d[3]);
    }
    __syncthreads();
    // both hidden tiles to scratch, 16 bytes a thread along the rows
    for (int i = threadIdx.x; i < M * (chunk / 8); i += kThreads) {
      const int r = i / (chunk / 8), c = (i - r * (chunk / 8)) * 8;
      if (t0 + r < p.n_tok) {
        const int64_t off = (t0 + r) * hidden + h0 + c;
        *reinterpret_cast<uint4*>(p.hg_s + off) = *reinterpret_cast<const uint4*>(hg + r * ldh + c);
        *reinterpret_cast<uint4*>(p.dh1_s + off) = *reinterpret_cast<const uint4*>(dh + r * ldh + c);
      }
    }
    for (int j = threadIdx.x; j < chunk; j += kThreads) {
      float sum = 0.f;
      for (int m = 0; m < M / 16; ++m) sum += colsum[m * chunk + j];
      p.fc1b_part[static_cast<int64_t>(blockIdx.x) * hidden + h0 + j] = sum;
    }
    staged_gemm<kGroup / 8, kCopies>(dyn, dh_addr, chunk, slab, odd_ld(C), n8, wn * kGroup, C,
                                     [&](int k, int c8) {
                                       return p.fc1_wt + static_cast<int64_t>(h0 + k) * C +
                                              c8 * 8;
                                     });
  }

  // 3. dyn (fp32) over the operand tiles; the LN2 backward, dy = g + round(du)
  // and the partials of dLN2 and of dbfc2 (the column sums of gz), a lane
  // summing its channels over its rows.
  float* dt = reinterpret_cast<float*>(smem + lay.yn);
#pragma unroll
  for (int nt = 0; nt < kGroup / 8; ++nt) {
    float* dst = dt + (mt * 16 + g) * lda + wn * kGroup + nt * 8 + 2 * t;
    *reinterpret_cast<float2*>(dst) = make_float2(dyn[nt][0], dyn[nt][1]);
    *reinterpret_cast<float2*>(dst + 8 * lda) = make_float2(dyn[nt][2], dyn[nt][3]);
  }
  __syncthreads();
  float s1[kLnChunks][8] = {}, s2[kLnChunks][8] = {}, s3[kLnChunks][8] = {};
  for (int r = rg; r < M; r += row_groups) {
    const int64_t tok = t0 + r;
    const bool valid = tok < p.n_tok;
    const float mu = mean[r], iv = inv[r];
    const float m2 = valid ? p.m2[tok / p.HW] : 0.f;
    float xh[kLnChunks][8], d[kLnChunks][8];
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int j = 0; j < kLnChunks; ++j) {
      const int c8 = sl + j * L;
      if (c8 < n8) {
        unpack8(*reinterpret_cast<const uint4*>(yt + r * lda + c8 * 8), xh[j]);
        float sc[8];
        unpack8(*reinterpret_cast<const uint4*>(p.ln2_s + c8 * 8), sc);
        const float4 da = *reinterpret_cast<const float4*>(dt + r * lda + c8 * 8);
        const float4 db = *reinterpret_cast<const float4*>(dt + r * lda + c8 * 8 + 4);
        d[j][0] = da.x; d[j][1] = da.y; d[j][2] = da.z; d[j][3] = da.w;
        d[j][4] = db.x; d[j][5] = db.y; d[j][6] = db.z; d[j][7] = db.w;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          xh[j][i] = (xh[j][i] - mu) * iv;
          const float gs = d[j][i] * sc[i];
          sa += gs;
          sb += gs * xh[j][i];
        }
      }
    }
    for (int o = L / 2; o > 0; o >>= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, o);
      sb += __shfl_xor_sync(0xffffffffu, sb, o);
    }
    const float ma = sa / C, mb = sb / C;
#pragma unroll
    for (int j = 0; j < kLnChunks; ++j) {
      const int c8 = sl + j * L;
      if (c8 < n8) {
        float sc[8], out[8];
        unpack8(*reinterpret_cast<const uint4*>(p.ln2_s + c8 * 8), sc);
        unpack8(*reinterpret_cast<const uint4*>(gt + r * lda + c8 * 8), out);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float du = (d[j][i] * sc[i] - ma - xh[j][i] * mb) * iv;
          s3[j][i] += rnd<bf16>(out[i] * m2);
          out[i] += rnd<bf16>(du);
          s1[j][i] += d[j][i] * xh[j][i];
          s2[j][i] += d[j][i];
        }
        if (valid) *reinterpret_cast<uint4*>(p.dy + tok * C + c8 * 8) = pack8(out);
      }
    }
  }
  float* psum = reinterpret_cast<float*>(slab);  // [row_groups][3][C]
#pragma unroll
  for (int j = 0; j < kLnChunks; ++j) {
    const int c8 = sl + j * L;
    if (c8 < n8) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        psum[(rg * 3) * C + c8 * 8 + i] = s1[j][i];
        psum[(rg * 3 + 1) * C + c8 * 8 + i] = s2[j][i];
        psum[(rg * 3 + 2) * C + c8 * 8 + i] = s3[j][i];
      }
    }
  }
  __syncthreads();
  float* part = p.ln_part + static_cast<int64_t>(blockIdx.x) * 3 * C;
  for (int idx = threadIdx.x; idx < 3 * C; idx += kThreads) {
    float sum = 0.f;
    for (int q = 0; q < row_groups; ++q) sum += psum[q * 3 * C + idx];
    part[idx] = sum;
  }
}

// part[z] = A[chunk z]^T B[chunk z] on the tensor cores: a 96 x 96 output tile
// a block of 4 warps (48 x 48 each: 3 x 6 mma tiles), the token direction is
// k. The operands' tiles lie in shared memory as [tokens][columns], so the A
// fragment of A^T comes from ldmatrix.trans as the B fragment does. 32 tokens
// a step through three buffers, the 16-byte cp.async copies two steps ahead;
// tokens past the chunk's end are zeros.
constexpr int kWgTile = 96, kWgTk = 32, kWgStages = 3, kWgLd = kWgTile + 8, kWgThreads = 128;

__global__ void __launch_bounds__(kWgThreads) wgrad_kernel(const bf16* A, int lda, const bf16* B,
                                                            int ldb, int64_t n_tok, int M,
                                                            int Ncol, int64_t chunk_len,
                                                            float* part) {
  __shared__ __align__(16) bf16 As[kWgStages][kWgTk][kWgLd];
  __shared__ __align__(16) bf16 Bs[kWgStages][kWgTk][kWgLd];
  const int i0 = blockIdx.y * kWgTile, j0 = blockIdx.x * kWgTile;
  const int64_t ta = min(n_tok, static_cast<int64_t>(blockIdx.z) * chunk_len);
  const int64_t tb = min(n_tok, ta + chunk_len);
  const int nstep = static_cast<int>((tb - ta + kWgTk - 1) / kWgTk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 1) * 48, n0 = (warp >> 1) * 48;
  constexpr int kC8 = kWgTile / 8, kPer = kWgTk * kC8 / kWgThreads;  // 3 copies an operand
  auto copy_step = [&](int s) {
    if (s < nstep) {
      const int64_t tbase = ta + static_cast<int64_t>(s) * kWgTk;
      const int st = s % kWgStages;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int idx = threadIdx.x + j * kWgThreads, r = idx / kC8, c = (idx % kC8) * 8;
        const bool valid = tbase + r < tb;
        const int64_t tok = valid ? tbase + r : ta;
        cp_async16_zfill(&As[st][r][c], A + tok * lda + i0 + c, valid);
        cp_async16_zfill(&Bs[st][r][c], B + tok * ldb + j0 + c, valid);
      }
    }
    cp_async_commit();
  };
  static_assert(kWgStages == 3, "the prologue copies two steps");
  copy_step(0);
  copy_step(1);
  float acc[3][6][4] = {};
  for (int s = 0; s < nstep; ++s) {
    cp_async_wait<kWgStages - 2>();
    __syncthreads();
    copy_step(s + kWgStages - 1);
    const int st = s % kWgStages;
#pragma unroll
    for (int kk = 0; kk < kWgTk / 16; ++kk) {
      uint32_t a[3][4];
#pragma unroll
      for (int mi = 0; mi < 3; ++mi)
        ldsm_x4_t(a[mi], smem_addr(&As[st][kk * 16 + (lane >> 4) * 8 + (lane & 7)]
                                      [m0 + mi * 16 + ((lane >> 3) & 1) * 8]));
#pragma unroll
      for (int np = 0; np < 3; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, smem_addr(&Bs[st][kk * 16 + (lane & 15)][n0 + np * 16 + (lane >> 4) * 8]));
#pragma unroll
        for (int mi = 0; mi < 3; ++mi) {
          mma_k16(acc[mi][2 * np], a[mi], b[0], b[1]);
          mma_k16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  float* out = part + static_cast<int64_t>(blockIdx.z) * M * Ncol;
#pragma unroll
  for (int mi = 0; mi < 3; ++mi) {
#pragma unroll
    for (int nt = 0; nt < 6; ++nt) {
      float* dst = out + static_cast<int64_t>(i0 + m0 + mi * 16 + g) * Ncol + j0 + n0 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(dst) = make_float2(acc[mi][nt][0], acc[mi][nt][1]);
      *reinterpret_cast<float2*>(dst + 8 * static_cast<int64_t>(Ncol)) =
          make_float2(acc[mi][nt][2], acc[mi][nt][3]);
    }
  }
}


// -- K9 on the tensor cores: bf16, 8x8 windows, head dim 24, C = 96, 192, 384 --

constexpr int kN = 64;               // tokens per window
constexpr int kD = 24;               // head dim
constexpr int kHeads = kGroup / kD;  // heads a column group
constexpr int kQkv = 3 * kD;         // q, k, v columns of one head
constexpr int kKvLd = 40;            // row length of the 24-wide tiles: k, v, qs, staging
constexpr int kPLd = 72;             // row length of the 64-wide tiles: rnd(p), rnd(ds)
constexpr int kAttnGroups = 2;       // most column groups a per-window block holds
constexpr int kRowChunks = 3;        // row passes: 8-channel chunks a lane holds (C / 24 lanes)
// bytes of one (window, column group)'s head tiles: k, v, qs [64][kKvLd] and
// rnd(p), rnd(ds) [64][kPLd]
constexpr int kHeadTiles = (3 * kN * kKvLd + 2 * kN * kPLd) * 2;

struct AttnBwdTc {
  const bf16 *x, *g, *ln1_s, *ln1_b, *qkv_w, *qkv_b, *proj_wt, *qkv_wt;
  const float *m1, *bias;
  bf16 *dx, *xn_s, *go_s, *o_s, *dqkv_s;
  float *dbias_part, *ln_part;
  int64_t n_tok;
  int B, H, W, C, heads, shift;
  float eps, scale;
};

// The per-window kernel's block: gb = min(C / 96, 2) column groups of warps
// over M = 128 / gb rows (two windows at C = 96, else one; at C = 384 the
// window's four groups are split over two blocks).
__host__ __device__ inline int attn_groups(int C) {
  return C / kGroup < kAttnGroups ? C / kGroup : kAttnGroups;
}
__host__ __device__ inline int attn_rows(int C) { return (kThreads / 32) / attn_groups(C) * 16; }

// Byte offsets of the per-window kernel's shared memory. K9: the bf16 row
// tiles [M][C + 8] of LN1(x) (at 0) and of go, over which do = go Wproj^T
// lies for the block's columns after the first product. K6: one row tile
// [M][C + 8], g's rows for the first product and x's after it, and the do
// tile [M][96 gb + 8] of the block's columns. Then the head tiles of each
// (window, group), over which the first product stages its slabs; the qkv
// slab buffers [3][32][odd_ld(72 gb)]; a [16][kKvLd] staging tile a warp.
// K6 at C = 768 (M = 64, gb = 2): 99,328 + 25,600 + 2 x 33,792 (heads) +
// 29,184 (slabs) + 10,240 (staging) = 231,936 of the 232,448 bytes a block
// may take; a second row tile (K9's layout) would need 305,664.
struct AttnSmem {
  int go, heads, slab, stage, total;
};
__host__ __device__ inline AttnSmem attn_smem(int C, bool ln) {
  const int M = attn_rows(C), gb = attn_groups(C), tile = M * (C + 8) * 2;
  AttnSmem s;
  s.go = tile;
  s.heads = s.go + (ln ? tile : M * (kGroup * gb + 8) * 2);
  s.slab = s.heads + (M / kN) * gb * kHeadTiles;
  s.stage = s.slab + kSlabStages * kSlabRows * odd_ld(kQkv * gb) * 2;
  s.total = s.stage + (kThreads / 32) * 16 * kKvLd * 2;
  return s;
}

// 16 rows x 24 columns of C fragments, rounded, out to rows `ld` elements
// apart at dst (16-byte aligned): through the warp's staging tile, 16 bytes
// a lane.
__device__ __forceinline__ void put_16x24(const float (&v)[kD / 8][4], bf16* stage, bf16* dst,
                                          int64_t ld, bool valid) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt) {
    *reinterpret_cast<uint32_t*>(stage + g * kKvLd + nt * 8 + 2 * t) = pack2(v[nt][0], v[nt][1]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * kKvLd + nt * 8 + 2 * t) =
        pack2(v[nt][2], v[nt][3]);
  }
  __syncwarp();
  if (valid) {
    for (int i = lane; i < 16 * (kD / 8); i += 32) {
      const int r = i / (kD / 8), c = (i - r * (kD / 8)) * 8;
      *reinterpret_cast<uint4*>(dst + r * ld + c) =
          *reinterpret_cast<const uint4*>(stage + r * kKvLd + c);
    }
  }
  __syncwarp();
}

// Kernel A, per window (two at C = 96) and gb column groups. K9: LN1(x) and
// go = dy m1 for the block's rows (the block's columns of both to scratch),
// do = go Wproj^T. K6 (xn = x, go = g): g's rows, the block's columns to
// scratch, do = g Wproj^T for the block's columns into the do tile, then x's
// rows over g's (the block's columns to scratch). Then per head of the warp's
// group, for the warp's 16 query rows: qkv recomputed, scores and softmax on
// the fragments, o = rnd(p) v, dp = do v^T, ds = p (dp - rowsum(dp p)) (fp32
// to dbias_part), dq = rnd(ds) k; after one barrier, for the warp's 16 key
// rows, dk = rnd(ds)^T qs and dv = rnd(p)^T do from the head tiles of all 64
// rows. Scratch rows are window-major.
template <bool kLn>
__global__ void __launch_bounds__(kThreads, 1) attn_bwd_kernel(AttnBwdTc p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = p.C, C3 = 3 * C, lda = C + 8, n8 = C / 8;
  const int gb = attn_groups(C), M = attn_rows(C), cg0 = blockIdx.y * gb;
  const AttnSmem lay = attn_smem(C, kLn);
  bf16* xn = reinterpret_cast<bf16*>(smem);
  bf16* gt = reinterpret_cast<bf16*>(smem + lay.go);  // K9: go, then do; K6: do
  // do of the block's columns: row length and the column of head 0 of group cg0
  const int ldo = kLn ? lda : kGroup * gb + 8, do0 = kLn ? cg0 * kGroup : 0;
  unsigned char* heads = smem + lay.heads;
  bf16* slab = reinterpret_cast<bf16*>(smem + lay.slab);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  bf16* stage = reinterpret_cast<bf16*>(smem + lay.stage) + warp * 16 * kKvLd;
  const int mt = warp % (M / 16), wn = warp / (M / 16);
  const int nWin = (p.H / 8) * (p.W / 8), total = p.B * nWin, win0 = blockIdx.x * (M / kN);
  auto tok = [&](int gw, int r) {
    return tok_offset(gw / nWin, gw % nWin, r, p.H, p.W, C, 8, p.shift);
  };

  // The rows of `src` (x, dy or g) into the row tile `dst`, and those of
  // `src2` into `dst2` unless it is null, 16 bytes a thread with every copy in
  // flight (rows of windows past the last: zeros).
  auto load_rows = [&](bf16* dst, const bf16* src, bf16* dst2, const bf16* src2) {
    for (int i = threadIdx.x; i < M * n8; i += kThreads) {
      const int r = i / n8, c = (i - r * n8) * 8;
      const int gw = win0 + r / kN;
      const bool valid = gw < total;
      const int64_t off = valid ? tok(gw, r % kN) + c : 0;
      cp_async16_zfill(dst + r * lda + c, src + off, valid);
      if (dst2 != nullptr) cp_async16_zfill(dst2 + r * lda + c, src2 + off, valid);
    }
  };
  // The block's columns of row tile `src` to the window-major scratch `dst`.
  auto put_cols = [&](bf16* dst, const bf16* src) {
    constexpr int kC8 = kGroup / 8;
    for (int i = threadIdx.x; i < M * kC8 * gb; i += kThreads) {
      const int r = i / (kC8 * gb), c = (cg0 * kC8 + i - r * (kC8 * gb)) * 8;
      const int gw = win0 + r / kN;
      if (gw < total)
        *reinterpret_cast<uint4*>(dst + (static_cast<int64_t>(gw) * kN + r % kN) * C + c) =
            *reinterpret_cast<const uint4*>(src + r * lda + c);
    }
  };

  // 1. K9: the rows of x and dy. K6: the rows of g.
  if (kLn)
    load_rows(xn, p.x, gt, p.g);
  else
    load_rows(xn, p.g, nullptr, nullptr);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 2. K9: LN1(x) and go = rnd(dy rnd(m1)) in place, L = C / 24 lanes a row
  // holding its channels in registers (32 / L rows of a warp at once); the
  // block's columns of both to scratch. K6: the block's columns of go = g.
  if (!kLn) {
    put_cols(p.go_s, xn);
  } else {
    const int L = n8 / kRowChunks, sl = lane % L;
    const int row_groups = (kThreads / 32) * (32 / L), rg = warp * (32 / L) + lane / L;
    const int c8_lo = cg0 * (kGroup / 8), c8_hi = (cg0 + gb) * (kGroup / 8);
    for (int r = rg; r < M; r += row_groups) {
      const int gw = win0 + r / kN;
      const bool valid = gw < total;
      const int64_t srow = static_cast<int64_t>(gw) * kN + r % kN;
      float v[kRowChunks][8];
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kRowChunks; ++j) {
        unpack8(*reinterpret_cast<const uint4*>(xn + r * lda + (sl + j * L) * 8), v[j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) sum += v[j][i];
      }
      for (int o = L / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float mu = sum / C;
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < kRowChunks; ++j) {
#pragma unroll
        for (int i = 0; i < 8; ++i) sq += (v[j][i] - mu) * (v[j][i] - mu);
      }
      for (int o = L / 2; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
      const float iv = 1.f / sqrtf(sq / C + p.eps);
      const float m1 = valid ? rnd<bf16>(p.m1[gw / nWin]) : 0.f;
#pragma unroll
      for (int j = 0; j < kRowChunks; ++j) {
        const int c8 = sl + j * L;
        float sc[8], bb[8], gv[8];
        unpack8(*reinterpret_cast<const uint4*>(p.ln1_s + c8 * 8), sc);
        unpack8(*reinterpret_cast<const uint4*>(p.ln1_b + c8 * 8), bb);
        unpack8(*reinterpret_cast<const uint4*>(gt + r * lda + c8 * 8), gv);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          v[j][i] = (v[j][i] - mu) * iv * sc[i] + bb[i];
          gv[i] *= m1;
        }
        const uint4 xv = pack8(v[j]), zv = pack8(gv);
        *reinterpret_cast<uint4*>(xn + r * lda + c8 * 8) = xv;
        *reinterpret_cast<uint4*>(gt + r * lda + c8 * 8) = zv;
        if (valid && c8 >= c8_lo && c8 < c8_hi) {
          *reinterpret_cast<uint4*>(p.xn_s + srow * C + c8 * 8) = xv;
          *reinterpret_cast<uint4*>(p.go_s + srow * C + c8 * 8) = zv;
        }
      }
    }
  }

  // 3. do = go Wproj^T for the warp's rows and group (Wproj^T staged over the
  // head tiles), rounded into go's tile (K9) or the do tile (K6) once every
  // warp is done reading go.
  const int row = mt * 16 + (lane & 15);
  {
    float acc[kGroup / 8][4] = {};
    staged_gemm<kGroup / 8>(acc, smem_addr((kLn ? gt : xn) + row * lda + (lane >> 4) * 8), C,
                            reinterpret_cast<bf16*>(heads), odd_ld(kGroup * gb),
                            (kGroup / 8) * gb, wn * kGroup, C, [&](int k, int c8) {
                              return p.proj_wt + static_cast<int64_t>(k) * C + cg0 * kGroup +
                                     c8 * 8;
                            });
#pragma unroll
    for (int nt = 0; nt < kGroup / 8; ++nt) {
      bf16* dst = gt + (mt * 16 + g) * ldo + do0 + wn * kGroup + nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dst) = pack2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<uint32_t*>(dst + 8 * ldo) = pack2(acc[nt][2], acc[nt][3]);
    }
  }
  // K6: x's rows over g's (every warp is done reading g), the block's
  // columns of xn = x to scratch.
  if (!kLn) {
    load_rows(xn, p.x, nullptr, nullptr);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    put_cols(p.xn_s, xn);
  }

  // 4. One head of the warp's group at a time.
  const int wl = mt / 4, rw = (mt % 4) * 16;  // local window; first row in it
  const int gw = win0 + wl;
  const bool valid = gw < total;
  const int win = gw % nWin;
  bf16* ks = reinterpret_cast<bf16*>(heads + (wl * gb + wn) * kHeadTiles);
  bf16* vs = ks + kN * kKvLd;
  bf16* qs = vs + kN * kKvLd;
  bf16* pt = qs + kN * kKvLd;
  bf16* dst_ = pt + kN * kPLd;
  const int64_t srow = static_cast<int64_t>(gw) * kN + rw;  // scratch row of the warp's row 0
  const uint32_t xn_addr = smem_addr(xn + row * lda + (lane >> 4) * 8);
  const uint32_t k_addr =
      smem_addr(ks + (lane & 7) * kKvLd + ((lane >> 3) < 2 ? (lane >> 3) : 2) * 8);
  const uint32_t v_addr =
      smem_addr(vs + (lane & 7) * kKvLd + ((lane >> 3) < 2 ? (lane >> 3) : 2) * 8);
  for (int it = 0; it < kHeads; ++it) {
    const int head = (cg0 + wn) * kHeads + it;
    // the head's do columns in its tile (K9: go's tile, every head's columns)
    const int dcol = kLn ? head * kD : (wn * kHeads + it) * kD;
    // q, k, v of this head for the warp's 16 rows
    float acc[kQkv / 8][4] = {};
    staged_gemm<kQkv / 8>(acc, xn_addr, C, slab, odd_ld(kQkv * gb), (kQkv / 8) * gb, wn * kQkv,
                          C3, [&](int k, int c8) {
                            const int grp = c8 / (kQkv / 8), j = c8 % (kQkv / 8);
                            const int hd = (cg0 + grp) * kHeads + it;
                            return p.qkv_w + static_cast<int64_t>(k) * C3 + (j / 3) * C +
                                   hd * kD + (j % 3) * 8;
                          });
    uint32_t qa[4], qb[2];
#pragma unroll
    for (int nt = 0; nt < kQkv / 8; ++nt) {
      const int part = nt / 3, j = (nt % 3) * 8 + 2 * t;
      const float2 bv =
          unpack2(*reinterpret_cast<const uint32_t*>(p.qkv_b + part * C + head * kD + j));
      const float v0 = rnd<bf16>(acc[nt][0] + bv.x), v1 = rnd<bf16>(acc[nt][1] + bv.y);
      const float v2 = rnd<bf16>(acc[nt][2] + bv.x), v3 = rnd<bf16>(acc[nt][3] + bv.y);
      uint32_t lo, hi;
      bf16* dst;
      if (part == 0) {  // qs = rnd(q * scale): the A fragments of q k^T, and a tile for dk
        lo = pack2(v0 * p.scale, v1 * p.scale);
        hi = pack2(v2 * p.scale, v3 * p.scale);
        if (nt == 0) { qa[0] = lo; qa[1] = hi; }
        if (nt == 1) { qa[2] = lo; qa[3] = hi; }
        if (nt == 2) { qb[0] = lo; qb[1] = hi; }
        dst = qs;
      } else {
        lo = pack2(v0, v1);
        hi = pack2(v2, v3);
        dst = part == 1 ? ks : vs;
      }
      *reinterpret_cast<uint32_t*>(dst + (rw + g) * kKvLd + j) = lo;
      *reinterpret_cast<uint32_t*>(dst + (rw + g + 8) * kKvLd + j) = hi;
    }
    __syncthreads();  // k, v, qs of the window's 64 rows are in place

    // scores = qs k^T + bias: 8 column tiles of 8 keys, depth 24 = 16 + 8
    float s[kN / 8][4] = {};
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
      uint32_t kb[4];
      ldsm_x4(kb, k_addr + nt * 8 * kKvLd * 2);
      mma_k16(s[nt], qa, kb[0], kb[1]);
      mma_k8(s[nt], qb[0], qb[1], kb[2]);
    }
    if (valid) {
      const float* bp = p.bias + ((static_cast<int64_t>(win) * p.heads + head) * kN + rw + g) * kN +
                        2 * t;
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt) {
        const float2 u = *reinterpret_cast<const float2*>(bp + nt * 8);
        const float2 l = *reinterpret_cast<const float2*>(bp + 8 * kN + nt * 8);
        s[nt][0] += u.x; s[nt][1] += u.y; s[nt][2] += l.x; s[nt][3] += l.y;
      }
    }
    // p = softmax, rows g (values 0, 1) and g + 8 (values 2, 3) over the quad,
    // kept in fp32; rnd(p) packed (the A fragments of p v) and into its tile
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
    uint32_t pk[kN / 8][2];
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
      s[nt][0] /= l0; s[nt][1] /= l0; s[nt][2] /= l1; s[nt][3] /= l1;
      pk[nt][0] = pack2(s[nt][0], s[nt][1]);
      pk[nt][1] = pack2(s[nt][2], s[nt][3]);
      *reinterpret_cast<uint32_t*>(pt + (rw + g) * kPLd + nt * 8 + 2 * t) = pk[nt][0];
      *reinterpret_cast<uint32_t*>(pt + (rw + g + 8) * kPLd + nt * 8 + 2 * t) = pk[nt][1];
    }

    // o = rnd(p) v: depth 64, width 24
    {
      float o[kD / 8][4] = {};
      const bf16* vrow = vs + (lane & 15) * kKvLd;
#pragma unroll
      for (int j = 0; j < kN / 16; ++j) {
        const uint32_t pa[4] = {pk[2 * j][0], pk[2 * j][1], pk[2 * j + 1][0], pk[2 * j + 1][1]};
        uint32_t vb[4], vc[2];
        ldsm_x4_t(vb, smem_addr(vrow + j * 16 * kKvLd + (lane >> 4) * 8));
        ldsm_x2_t(vc, smem_addr(vrow + j * 16 * kKvLd + 16));
        mma_k16(o[0], pa, vb[0], vb[1]);
        mma_k16(o[1], pa, vb[2], vb[3]);
        mma_k16(o[2], pa, vc[0], vc[1]);
      }
      put_16x24(o, stage, p.o_s + srow * C + head * kD, C, valid);
    }

    // dp = do v^T: do's A fragments from its tile, v read as k is in q k^T
    float dp[kN / 8][4] = {};
    {
      uint32_t da[4], db[2];
      ldsm_x4(da, smem_addr(gt + row * ldo + dcol + (lane >> 4) * 8));
      ldsm_x2(db, smem_addr(gt + row * ldo + dcol + 16));
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt) {
        uint32_t vb[4];
        ldsm_x4(vb, v_addr + nt * 8 * kKvLd * 2);
        mma_k16(dp[nt], da, vb[0], vb[1]);
        mma_k8(dp[nt], db[0], db[1], vb[2]);
      }
    }
    // ds = p (dp - rowsum(dp p)) in fp32 (over dp), to dbias_part before rounding
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
      r0 += dp[nt][0] * s[nt][0] + dp[nt][1] * s[nt][1];
      r1 += dp[nt][2] * s[nt][2] + dp[nt][3] * s[nt][3];
    }
    r0 += __shfl_xor_sync(0xffffffffu, r0, 1);
    r0 += __shfl_xor_sync(0xffffffffu, r0, 2);
    r1 += __shfl_xor_sync(0xffffffffu, r1, 1);
    r1 += __shfl_xor_sync(0xffffffffu, r1, 2);
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
      dp[nt][0] = s[nt][0] * (dp[nt][0] - r0);
      dp[nt][1] = s[nt][1] * (dp[nt][1] - r0);
      dp[nt][2] = s[nt][2] * (dp[nt][2] - r1);
      dp[nt][3] = s[nt][3] * (dp[nt][3] - r1);
    }
    if (valid) {
      float* db = p.dbias_part + ((static_cast<int64_t>(gw) * p.heads + head) * kN + rw + g) * kN +
                  2 * t;
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt) {
        *reinterpret_cast<float2*>(db + nt * 8) = make_float2(dp[nt][0], dp[nt][1]);
        *reinterpret_cast<float2*>(db + 8 * kN + nt * 8) = make_float2(dp[nt][2], dp[nt][3]);
      }
    }
    // rnd(ds): packed (the A fragments of ds k) and into its tile
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
      pk[nt][0] = pack2(dp[nt][0], dp[nt][1]);
      pk[nt][1] = pack2(dp[nt][2], dp[nt][3]);
      *reinterpret_cast<uint32_t*>(dst_ + (rw + g) * kPLd + nt * 8 + 2 * t) = pk[nt][0];
      *reinterpret_cast<uint32_t*>(dst_ + (rw + g + 8) * kPLd + nt * 8 + 2 * t) = pk[nt][1];
    }
    // dq = rnd(rnd(rnd(ds) k) scale): k read as v is in p v
    {
      float dq[kD / 8][4] = {};
      const bf16* krow = ks + (lane & 15) * kKvLd;
#pragma unroll
      for (int j = 0; j < kN / 16; ++j) {
        const uint32_t pa[4] = {pk[2 * j][0], pk[2 * j][1], pk[2 * j + 1][0], pk[2 * j + 1][1]};
        uint32_t kb[4], kc[2];
        ldsm_x4_t(kb, smem_addr(krow + j * 16 * kKvLd + (lane >> 4) * 8));
        ldsm_x2_t(kc, smem_addr(krow + j * 16 * kKvLd + 16));
        mma_k16(dq[0], pa, kb[0], kb[1]);
        mma_k16(dq[1], pa, kb[2], kb[3]);
        mma_k16(dq[2], pa, kc[0], kc[1]);
      }
#pragma unroll
      for (int nt = 0; nt < kD / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[nt][i] = rnd<bf16>(rnd<bf16>(dq[nt][i]) * p.scale);
      put_16x24(dq, stage, p.dqkv_s + srow * C3 + head * kD, C3, valid);
    }
    __syncthreads();  // rnd(p) and rnd(ds) of the window's 64 rows are in place

    // dk = rnd(ds)^T qs and dv = rnd(p)^T do for the warp's 16 key rows: the A
    // fragments of the transposes by ldmatrix.trans of the [query][key] tiles
    {
      float dk[kD / 8][4] = {}, dv[kD / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        const int ar = kk * 16 + (lane >> 4) * 8 + (lane & 7), ac = rw + ((lane >> 3) & 1) * 8;
        uint32_t a[4], b4[4], b2[2];
        ldsm_x4_t(a, smem_addr(dst_ + ar * kPLd + ac));
        const bf16* qrow = qs + (kk * 16 + (lane & 15)) * kKvLd;
        ldsm_x4_t(b4, smem_addr(qrow + (lane >> 4) * 8));
        ldsm_x2_t(b2, smem_addr(qrow + 16));
        mma_k16(dk[0], a, b4[0], b4[1]);
        mma_k16(dk[1], a, b4[2], b4[3]);
        mma_k16(dk[2], a, b2[0], b2[1]);
        ldsm_x4_t(a, smem_addr(pt + ar * kPLd + ac));
        const bf16* drow = gt + (wl * kN + kk * 16 + (lane & 15)) * ldo + dcol;
        ldsm_x4_t(b4, smem_addr(drow + (lane >> 4) * 8));
        ldsm_x2_t(b2, smem_addr(drow + 16));
        mma_k16(dv[0], a, b4[0], b4[1]);
        mma_k16(dv[1], a, b4[2], b4[3]);
        mma_k16(dv[2], a, b2[0], b2[1]);
      }
      put_16x24(dk, stage, p.dqkv_s + srow * C3 + C + head * kD, C3, valid);
      put_16x24(dv, stage, p.dqkv_s + srow * C3 + 2 * C + head * kD, C3, valid);
    }
    // the next head's product syncs before it overwrites the head tiles
  }
}

// Kernel B's shared memory: the bf16 dqkv row tile [M][3C + 8] (at 0; the
// fp32 dxn tile [M][C + 8] (K9) or the bf16 dx tile (K6) lies over it after
// the product), K9's x and dy row tiles [M][C + 8], the slab buffers
// [3][32][odd_ld(C)], over which K9's partial sums [warps][3][C] lie at the
// end. K6 at C = 768 (M = 16): 73,984 + 148,992 = 222,976 bytes; K9's two
// row tiles would add 49,664.
struct DxSmem {
  int x, dy, slab, total;
};
__host__ __device__ inline DxSmem dx_smem(int M, int C, bool ln) {
  DxSmem s;
  s.x = M * (3 * C + 8) * 2;
  s.dy = s.x + (ln ? M * (C + 8) * 2 : 0);
  s.slab = s.dy + (ln ? M * (C + 8) * 2 : 0);
  s.total = s.slab + kSlabStages * kSlabRows * odd_ld(C) * 2;
  return s;
}

// Kernel B, per M = 128 / (C / 96) window-major scratch rows (a warp: 16 rows
// x 96 columns): dxn = rnd(dqkv Wqkv^T) (Wqkv^T staged). K9: then the LN1
// backward with the row statistics recomputed from x, dx = rnd(dy + rnd(du))
// at the tokens' places, and the block's partials [6C]: sum dxn xhat, sum
// dxn (dLN1), sum go (the proj bias gradient, go = rnd(dy rnd(m1))), and the
// column sums of dqkv (the qkv bias gradient). K6: dx = dxn at the tokens'
// places, and the partials [4C]: sum go (go = g, read at the tokens' places),
// then the column sums of dqkv.
template <bool kLn>
__global__ void __launch_bounds__(kThreads, 1) attn_dx_kernel(AttnBwdTc p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = p.C, C3 = 3 * C, groups = C / kGroup, M = kRows / groups;
  const int lda = C + 8, ldq = C3 + 8, n8 = C / 8;
  const DxSmem lay = dx_smem(M, C, kLn);
  bf16* dq = reinterpret_cast<bf16*>(smem);
  bf16* xt = reinterpret_cast<bf16*>(smem + lay.x);
  bf16* yt = reinterpret_cast<bf16*>(smem + lay.dy);
  bf16* slab = reinterpret_cast<bf16*>(smem + lay.slab);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int mt = warp % (M / 16), wn = warp / (M / 16);
  const int nWin = (p.H / 8) * (p.W / 8);
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * M;
  auto tok = [&](int64_t row) {
    const int gw = static_cast<int>(row / kN);
    return tok_offset(gw / nWin, gw % nWin, static_cast<int>(row % kN), p.H, p.W, C, 8, p.shift);
  };

  // 1. The dqkv rows, and the rows of x and dy at the tokens' places, all in flight.
  for (int i = threadIdx.x; i < M * (C3 / 8); i += kThreads) {
    const int r = i / (C3 / 8), c = (i - r * (C3 / 8)) * 8;
    const bool valid = t0 + r < p.n_tok;
    cp_async16_zfill(dq + r * ldq + c, p.dqkv_s + (valid ? (t0 + r) * C3 + c : 0), valid);
  }
  if (kLn) {
    for (int i = threadIdx.x; i < M * n8; i += kThreads) {
      const int r = i / n8, c = (i - r * n8) * 8;
      const bool valid = t0 + r < p.n_tok;
      const int64_t off = valid ? tok(t0 + r) + c : 0;
      cp_async16_zfill(xt + r * lda + c, p.x + off, valid);
      cp_async16_zfill(yt + r * lda + c, p.g + off, valid);
    }
  }
  cp_async_commit();
  float* part = p.ln_part + static_cast<int64_t>(blockIdx.x) * (kLn ? 6 : 4) * C;
  if (!kLn) {  // K6: go = g's column sums over the block's rows, while the copies fly
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float sum = 0.f;
#pragma unroll 16
      for (int r = 0; r < M; ++r)
        sum += t0 + r < p.n_tok ? __bfloat162float(p.g[tok(t0 + r) + c]) : 0.f;
      part[c] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int c = threadIdx.x; c < C3; c += kThreads) {
    float sum = 0.f;
    for (int r = 0; r < M; ++r) sum += __bfloat162float(dq[r * ldq + c]);
    part[(kLn ? 3 : 1) * C + c] = sum;
  }

  // 2. dxn = dqkv Wqkv^T, K = 3C (a slab of 32 x C over 256 threads: 6
  // copies a thread at C <= 384, 12 at 768).
  float acc[kGroup / 8][4] = {};
  staged_gemm<kGroup / 8, kLn ? kCopies : 2 * kCopies>(
      acc, smem_addr(dq + (mt * 16 + (lane & 15)) * ldq + (lane >> 4) * 8), C3, slab, odd_ld(C),
      n8, wn * kGroup, C,
      [&](int k, int c8) { return p.qkv_wt + static_cast<int64_t>(k) * C + c8 * 8; });
  if (!kLn) {
    // K6: dx = rnd(dxn) into a bf16 tile over the dqkv tile, then 16 bytes a
    // thread to the tokens' places.
    bf16* ot = reinterpret_cast<bf16*>(smem);
#pragma unroll
    for (int nt = 0; nt < kGroup / 8; ++nt) {
      bf16* d = ot + (mt * 16 + g) * lda + wn * kGroup + nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(d) = pack2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<uint32_t*>(d + 8 * lda) = pack2(acc[nt][2], acc[nt][3]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < M * n8; i += kThreads) {
      const int r = i / n8, c = (i - r * n8) * 8;
      if (t0 + r < p.n_tok)
        *reinterpret_cast<uint4*>(p.dx + tok(t0 + r) + c) =
            *reinterpret_cast<const uint4*>(ot + r * lda + c);
    }
    return;
  }
  // K9: rounded, in fp32 over the dqkv tile.
  float* dt = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int nt = 0; nt < kGroup / 8; ++nt) {
    float* d = dt + (mt * 16 + g) * lda + wn * kGroup + nt * 8 + 2 * t;
    *reinterpret_cast<float2*>(d) = make_float2(rnd<bf16>(acc[nt][0]), rnd<bf16>(acc[nt][1]));
    *reinterpret_cast<float2*>(d + 8 * lda) =
        make_float2(rnd<bf16>(acc[nt][2]), rnd<bf16>(acc[nt][3]));
  }
  __syncthreads();

  // 3. The LN1 backward per row, L = C / 24 lanes a row (32 / L rows of a
  // warp at once); a lane sums its channels over its rows, then over the
  // warp's lanes that hold the same channels, in a fixed order.
  const int L = n8 / kRowChunks, sl = lane % L;
  const int row_groups = (kThreads / 32) * (32 / L), rg = warp * (32 / L) + lane / L;
  float s1[kRowChunks][8] = {}, s2[kRowChunks][8] = {}, s3[kRowChunks][8] = {};
  for (int r = rg; r < M; r += row_groups) {
    const bool valid = t0 + r < p.n_tok;
    const int64_t off = valid ? tok(t0 + r) : 0;
    const float m1 = valid ? rnd<bf16>(p.m1[(t0 + r) / kN / nWin]) : 0.f;
    float xh[kRowChunks][8], d[kRowChunks][8];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kRowChunks; ++j) {
      unpack8(*reinterpret_cast<const uint4*>(xt + r * lda + (sl + j * L) * 8), xh[j]);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += xh[j][i];
    }
    for (int o = L / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mu = sum / C;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < kRowChunks; ++j) {
#pragma unroll
      for (int i = 0; i < 8; ++i) sq += (xh[j][i] - mu) * (xh[j][i] - mu);
    }
    for (int o = L / 2; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float iv = 1.f / sqrtf(sq / C + p.eps);
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int j = 0; j < kRowChunks; ++j) {
      const int c8 = sl + j * L;
      float sc[8];
      unpack8(*reinterpret_cast<const uint4*>(p.ln1_s + c8 * 8), sc);
      const float4 da = *reinterpret_cast<const float4*>(dt + r * lda + c8 * 8);
      const float4 db = *reinterpret_cast<const float4*>(dt + r * lda + c8 * 8 + 4);
      d[j][0] = da.x; d[j][1] = da.y; d[j][2] = da.z; d[j][3] = da.w;
      d[j][4] = db.x; d[j][5] = db.y; d[j][6] = db.z; d[j][7] = db.w;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        xh[j][i] = (xh[j][i] - mu) * iv;
        const float gs = d[j][i] * sc[i];
        sa += gs;
        sb += gs * xh[j][i];
      }
    }
    for (int o = L / 2; o > 0; o >>= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, o);
      sb += __shfl_xor_sync(0xffffffffu, sb, o);
    }
    const float ma = sa / C, mb = sb / C;
#pragma unroll
    for (int j = 0; j < kRowChunks; ++j) {
      const int c8 = sl + j * L;
      float sc[8], out[8];
      unpack8(*reinterpret_cast<const uint4*>(p.ln1_s + c8 * 8), sc);
      unpack8(*reinterpret_cast<const uint4*>(yt + r * lda + c8 * 8), out);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float du = (d[j][i] * sc[i] - ma - xh[j][i] * mb) * iv;
        s3[j][i] += rnd<bf16>(out[i] * m1);
        out[i] += rnd<bf16>(du);
        s1[j][i] += d[j][i] * xh[j][i];
        s2[j][i] += d[j][i];
      }
      if (valid) *reinterpret_cast<uint4*>(p.dx + off + c8 * 8) = pack8(out);
    }
  }
#pragma unroll
  for (int j = 0; j < kRowChunks; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      for (int o = L; o < 32; o <<= 1) {
        s1[j][i] += __shfl_xor_sync(0xffffffffu, s1[j][i], o);
        s2[j][i] += __shfl_xor_sync(0xffffffffu, s2[j][i], o);
        s3[j][i] += __shfl_xor_sync(0xffffffffu, s3[j][i], o);
      }
    }
  }
  float* psum = reinterpret_cast<float*>(slab);  // [warps][3][C]
  if (lane < L) {
#pragma unroll
    for (int j = 0; j < kRowChunks; ++j) {
      const int c = (sl + j * L) * 8;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        psum[(warp * 3) * C + c + i] = s1[j][i];
        psum[(warp * 3 + 1) * C + c + i] = s2[j][i];
        psum[(warp * 3 + 2) * C + c + i] = s3[j][i];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 3 * C; idx += kThreads) {
    float sum = 0.f;
    for (int q = 0; q < kThreads / 32; ++q) sum += psum[q * 3 * C + idx];
    part[idx] = sum;
  }
}

}  // namespace tc

template <typename K, typename P>
int launch(K kernel, const P& p, int n_blocks, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_blocks, block_threads(smem), smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// A tensor-core kernel of tc::kThreads threads a block over `grid`.
template <typename K, typename P>
int launch_grid(K kernel, const P& p, dim3 grid, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, tc::kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// parts: 1 the per-window kernel, 2 the dx kernel, 3 both.
template <typename T, bool kLn>
int attn_bwd_launch(const AttnBwd& p, int B, int parts, cudaStream_t s) {
  const int N = p.window * p.window, d = p.C / p.heads;
  const int n_win = B * (p.H / p.window) * (p.W / p.window);
  if (parts & 1) {
    const int rc = launch(attn_bwd_a<T, kLn>, p, n_win, attn_a_smem(sizeof(T), N, p.C, d), s);
    if (rc) return rc;
  }
  if (!(parts & 2)) return 0;
  return launch(attn_bwd_b<T, kLn>, p, n_win * (N / p.rows), attn_b_smem(p.C, p.rows), s);
}

}  // namespace

// Bytes of dynamic shared memory of each kernel: which 0 = the per-window
// attention kernel, 1 = the dx kernel with `rows` rows, 2 = K8 with `rows`.
extern "C" int swin_train_smem(int which, int itemsize, int N, int C, int d, int rows) {
  if (which == 0) return attn_a_smem(itemsize, N, C, d);
  if (which == 1) return attn_b_smem(C, rows);
  return mlp_a_smem(itemsize, C, rows);
}

extern "C" int swin_train_smem_limit() { return smem_limit(); }

// K6 (ln = 0: g is the output cotangent) or K9 (ln = 1: g is dy, with m1
// and LN1): the per-window kernel, then the dx kernel (parts: 1 the first
// alone, 2 the second alone, 3 both). Scratch rows B * nWin * N: xn_s, go_s,
// o_s, do_s [.., C], dqkv_s [.., 3C] in the activation dtype; dbias_part [B,
// nWin, heads, N, N] and ln_part [B * nWin * N / rows, 2, C] fp32. Returns
// cudaGetLastError() as an int.
extern "C" int swin_attn_bwd(int dtype, int ln, int parts, const void* x, const void* g,
                             const void* m1, const void* ln1_s, const void* ln1_b,
                             const void* qkv_w, const void* qkv_b, const void* proj_w,
                             const void* bias, void* dx, void* xn_s, void* go_s, void* o_s,
                             void* do_s, void* dqkv_s, void* dbias_part, void* ln_part, int B,
                             int H, int W, int C, int heads, int window, int shift, int rows,
                             float eps, float scale, void* stream) {
  const int N = window * window;
  if (heads <= 0 || C % heads || (C / heads) % 8 || N % 8 || H % window || W % window ||
      rows <= 0 || rows % 8 || N % rows || (ln && m1 == nullptr) || parts < 1 || parts > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AttnBwd p{x, g, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, static_cast<const float*>(m1),
            static_cast<const float*>(bias), dx, xn_s, go_s, o_s, do_s, dqkv_s,
            static_cast<float*>(dbias_part), static_cast<float*>(ln_part),
            H, W, C, heads, window, shift, rows, eps, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return ln ? attn_bwd_launch<float, true>(p, B, parts, s)
                            : attn_bwd_launch<float, false>(p, B, parts, s);
  if (dtype == 1) return ln ? attn_bwd_launch<__nv_bfloat16, true>(p, B, parts, s)
                            : attn_bwd_launch<__nv_bfloat16, false>(p, B, parts, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K9 (ln = 1: g is dy, with m1 and LN1) or K6 (ln = 0: g is the output
// cotangent) on the tensor cores (kernel A, then kernel B; parts: 1 the first
// alone, 2 the second alone, 3 both): bf16, 8x8 windows, C = 96 * groups with
// groups 1, 2 or 4 (K9) or 8 (K6) and heads = C / 24. proj_wt [C, C] and
// qkv_wt [3C, C] are the transposed weights; x, g and every row pointer
// 16-byte aligned. Scratch rows B * nWin * 64, window-major: xn_s, go_s, o_s
// [.., C], dqkv_s [.., 3C] bf16; dbias_part [B, nWin, heads, 64, 64] and
// ln_part [ceil(n_tok / (128 / groups)), 6 (K9) or 4 (K6), C] fp32 (K9:
// dLN1's two rows, then the proj and qkv bias gradients' partials; K6: the
// proj, then the qkv bias gradients' partials).
extern "C" int swin_attn_bwd_tc(int ln, int parts, const void* x, const void* g, const void* m1,
                                const void* ln1_s, const void* ln1_b, const void* qkv_w,
                                const void* qkv_b, const void* proj_wt, const void* qkv_wt,
                                const void* bias, void* dx, void* xn_s, void* go_s, void* o_s,
                                void* dqkv_s, void* dbias_part, void* ln_part, int B, int H, int W,
                                int C, int heads, int shift, float eps, float scale,
                                void* stream) {
  using tc::bf16;
  const int groups = C / tc::kGroup;
  const bool width = ln ? (groups == 1 || groups == 2 || groups == 4) : groups == 8;
  if (parts < 1 || parts > 3 || C % tc::kGroup || !width || heads * tc::kD != C || B <= 0 ||
      H <= 0 || W <= 0 || H % 8 || W % 8 || shift < 0 || (ln && m1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto in = [](const void* q) { return static_cast<const bf16*>(q); };
  auto out = [](void* q) { return static_cast<bf16*>(q); };
  tc::AttnBwdTc p{in(x), in(g), in(ln1_s), in(ln1_b), in(qkv_w), in(qkv_b), in(proj_wt),
                  in(qkv_wt), static_cast<const float*>(m1), static_cast<const float*>(bias),
                  out(dx), out(xn_s), out(go_s), out(o_s), out(dqkv_s),
                  static_cast<float*>(dbias_part), static_cast<float*>(ln_part),
                  static_cast<int64_t>(B) * H * W, B, H, W, C, heads, shift, eps, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (parts & 1) {
    const int smem = tc::attn_smem(C, ln).total, gb = tc::attn_groups(C);
    const int wpb = tc::attn_rows(C) / tc::kN;
    // the first product stages Wproj^T over the head tiles
    if (smem > smem_limit() ||
        kSlabStages * kSlabRows * odd_ld(tc::kGroup * gb) * 2 > wpb * gb * tc::kHeadTiles)
      return static_cast<int>(cudaErrorInvalidValue);
    const int total = B * (H / 8) * (W / 8);
    const dim3 grid((total + wpb - 1) / wpb, groups / gb);
    const int rc = ln ? launch_grid(tc::attn_bwd_kernel<true>, p, grid, smem, s)
                      : launch_grid(tc::attn_bwd_kernel<false>, p, grid, smem, s);
    if (rc) return rc;
  }
  if (parts & 2) {
    const int rows = tc::kRows / groups, smem = tc::dx_smem(rows, C, ln).total;
    if (smem > smem_limit()) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>((p.n_tok + rows - 1) / rows));
    const int rc = ln ? launch_grid(tc::attn_dx_kernel<true>, p, grid, smem, s)
                      : launch_grid(tc::attn_dx_kernel<false>, p, grid, smem, s);
    if (rc) return rc;
  }
  return 0;
}

// K8's per-token kernel over n_tok = B*H*W tokens in groups of `rows`
// (HW = H*W tokens per batch row, for m2). Scratch: yn_s, gz_s [n_tok, C],
// hg_s, dh1_s [n_tok, hidden] in the activation dtype; ln_part
// [n_tok / rows, 2, C] and fc1b_part [n_tok / rows, hidden] fp32.
extern "C" int swin_mlp_bwd(int dtype, const void* y, const void* g, const void* m2,
                            const void* ln2_s, const void* ln2_b, const void* fc1_w,
                            const void* fc1_b, const void* fc2_w, void* dy, void* yn_s,
                            void* gz_s, void* hg_s, void* dh1_s, void* ln_part, void* fc1b_part,
                            long long n_tok, int HW, int C, int hidden, int rows, float eps,
                            void* stream) {
  if (rows <= 0 || rows % 8 || n_tok % rows || HW <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  MlpBwd p{y, g, ln2_s, ln2_b, fc1_w, fc1_b, fc2_w, static_cast<const float*>(m2), dy, yn_s,
           gz_s, hg_s, dh1_s, static_cast<float*>(ln_part), static_cast<float*>(fc1b_part),
           HW, C, hidden, rows, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blocks = static_cast<int>(n_tok / rows);
  if (dtype == 0) return launch(mlp_bwd_a<float>, p, n_blocks, mlp_a_smem(4, C, rows), s);
  if (dtype == 1)
    return launch(mlp_bwd_a<__nv_bfloat16>, p, n_blocks, mlp_a_smem(2, C, rows), s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K8's per-token kernel on the tensor cores: bf16, C = 96 * groups with groups
// 1, 2 or 4, hidden a multiple of 64 * groups, `rows` = 128 / groups tokens a
// block (n_tok need not be a multiple of it). fc2_wt [C, hidden] and fc1_wt
// [hidden, C] are the transposed weights. Scratch as for swin_mlp_bwd, with
// ceil(n_tok / rows) rows of partials, and ln_part [.., 3, C]: its third row
// holds the column sums of gz (the fc2 bias gradient's partials).
extern "C" int swin_mlp_bwd_tc(const void* y, const void* g, const void* m2, const void* ln2_s,
                               const void* ln2_b, const void* fc1_w, const void* fc1_b,
                               const void* fc2_wt, const void* fc1_wt, void* dy, void* yn_s,
                               void* gz_s, void* hg_s, void* dh1_s, void* ln_part,
                               void* fc1b_part, long long n_tok, int HW, int C, int hidden,
                               int rows, float eps, void* stream) {
  using tc::bf16;
  const int groups = C / tc::kGroup;
  if (C % tc::kGroup || (groups != 1 && groups != 2 && groups != 4) || hidden <= 0 ||
      hidden % (groups * tc::kFc1) || rows * groups != tc::kRows || n_tok <= 0 || HW <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto in = [](const void* q) { return static_cast<const bf16*>(q); };
  auto out = [](void* q) { return static_cast<bf16*>(q); };
  tc::MlpBwdTc p{in(y), in(g), in(ln2_s), in(ln2_b), in(fc1_w), in(fc1_b), in(fc2_wt),
                 in(fc1_wt), static_cast<const float*>(m2), out(dy), out(yn_s), out(gz_s),
                 out(hg_s), out(dh1_s), static_cast<float*>(ln_part),
                 static_cast<float*>(fc1b_part), n_tok, HW, C, hidden, rows, eps};
  const int smem = tc::mlp_smem(rows, C).total;
  if (smem > smem_limit()) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(tc::mlp_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned n_blocks = static_cast<unsigned>((n_tok + rows - 1) / rows);
  tc::mlp_bwd_kernel<<<n_blocks, tc::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// out [M, Ncol] fp32 = A^T B over n_tok tokens (A [n_tok, lda], B [n_tok,
// ldb] in the activation dtype; A null: out [1, Ncol] = column sums of B),
// through n_chunks token chunks of partials in `part` ([n_chunks, M, Ncol]).
extern "C" int swin_wgrad(int dtype, const void* A, int lda, const void* B, int ldb,
                          long long n_tok, int M, int Ncol, int n_chunks, void* part, void* out,
                          void* stream) {
  if (n_chunks <= 0 || M <= 0 || Ncol <= 0 || (A == nullptr && M != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long chunk = (n_tok + n_chunks - 1) / n_chunks;
  dim3 grid((Ncol + kTile - 1) / kTile, (M + kTile - 1) / kTile, n_chunks);
  float* pp = static_cast<float*>(part);
  if (dtype == 0)
    wgrad_kernel<float><<<grid, 256, 0, s>>>(static_cast<const float*>(A), lda,
                                             static_cast<const float*>(B), ldb, n_tok, M, Ncol,
                                             chunk, pp);
  else if (dtype == 1)
    wgrad_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(A), lda, static_cast<const __nv_bfloat16*>(B), ldb,
        n_tok, M, Ncol, chunk, pp);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long len = static_cast<long long>(M) * Ncol;
  reduce_kernel<<<static_cast<unsigned>((len + 31) / 32), 256, 0, s>>>(pp, n_chunks, len,
                                                                      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The same product on the tensor cores: bf16, M and Ncol multiples of 96, lda
// and ldb multiples of 8 (16-byte rows). Chunks are a multiple of 32 tokens
// long; one past the last token gives zeros.
extern "C" int swin_wgrad_tc(const void* A, int lda, const void* B, int ldb, long long n_tok,
                             int M, int Ncol, int n_chunks, void* part, void* out,
                             void* stream) {
  if (A == nullptr || n_chunks <= 0 || n_tok <= 0 || M <= 0 || Ncol <= 0 || M % tc::kWgTile ||
      Ncol % tc::kWgTile || lda % 8 || ldb % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long per = (n_tok + n_chunks - 1) / n_chunks;
  const long long chunk = (per + tc::kWgTk - 1) / tc::kWgTk * tc::kWgTk;
  dim3 grid(Ncol / tc::kWgTile, M / tc::kWgTile, n_chunks);
  float* pp = static_cast<float*>(part);
  tc::wgrad_kernel<<<grid, tc::kWgThreads, 0, s>>>(static_cast<const tc::bf16*>(A), lda,
                                                   static_cast<const tc::bf16*>(B), ldb, n_tok,
                                                   M, Ncol, chunk, pp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long len = static_cast<long long>(M) * Ncol;
  reduce_kernel<<<static_cast<unsigned>((len + 31) / 32), 256, 0, s>>>(pp, n_chunks, len,
                                                                      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out [len] = sum over n_parts of part [n_parts, len], in a fixed order.
extern "C" int swin_reduce(const void* part, int n_parts, long long len, void* out, void* stream) {
  if (n_parts <= 0 || len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  reduce_kernel<<<static_cast<unsigned>((len + 31) / 32), 256, 0, s>>>(
      static_cast<const float*>(part), n_parts, len, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
