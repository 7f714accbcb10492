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
//   work as K3 does (one block per 8x8 window, one head at a time, the
//   cyclic shift folded into the index arithmetic on x, on the cotangents
//   and on dx alike) and writes the operands of the weight-gradient products
//   (LN'd input, go, o, dqkv; LN2(y), gz, gelu(h), dh) to scratch in the
//   activation dtype, rounded where the TPU kernel rounds them, plus fp32
//   per-block partials of the small reductions (dbias per batch row, the LN
//   gradients, K8's fc1 bias gradient, which sums dh before rounding);
// - dx of K6/K9 comes from a second per-row-group kernel, dqkv Wqkv^T
//   accumulated over 64-wide chunks in fp32 shared memory, then K9's LN1
//   backward and residual;
// - every weight gradient is a hand-written split-token product: each block
//   sums A^T B over one 64x64 output tile and one chunk of tokens into an
//   fp32 partial; a reduction kernel then adds the partials in a fixed
//   order. No atomics: results are deterministic run to run.
// Products are CUDA-core FMAs (head dim 24, as in K3); per-head buffers stay
// under the shared-memory limit up to C=768 in bf16 and C=384 in fp32.
//
// Numerics (the JAX kernels' rounding points): in the activation dtype T
// these round: go, do, dq (then dq * scale), dk, dv, dxn, gz, gelu(h), dh,
// the LN outputs and dx; softmax, ds, dp, LN statistics and every sum stay
// fp32. GELU and its derivative are exact (erff).
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

template <typename K, typename P>
int launch(K kernel, const P& p, int n_blocks, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_blocks, block_threads(smem), smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kLn>
int attn_bwd_launch(const AttnBwd& p, int B, cudaStream_t s) {
  const int N = p.window * p.window, d = p.C / p.heads;
  const int n_win = B * (p.H / p.window) * (p.W / p.window);
  int rc = launch(attn_bwd_a<T, kLn>, p, n_win, attn_a_smem(sizeof(T), N, p.C, d), s);
  if (rc) return rc;
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
// and LN1): the per-window kernel, then the dx kernel. Scratch rows
// B * nWin * N: xn_s, go_s, o_s, do_s [.., C], dqkv_s [.., 3C] in the
// activation dtype; dbias_part [B, nWin, heads, N, N] and ln_part
// [B * nWin * N / rows, 2, C] fp32. Returns cudaGetLastError() as an int.
extern "C" int swin_attn_bwd(int dtype, int ln, const void* x, const void* g, const void* m1,
                             const void* ln1_s, const void* ln1_b, const void* qkv_w,
                             const void* qkv_b, const void* proj_w, const void* bias, void* dx,
                             void* xn_s, void* go_s, void* o_s, void* do_s, void* dqkv_s,
                             void* dbias_part, void* ln_part, int B, int H, int W, int C,
                             int heads, int window, int shift, int rows, float eps, float scale,
                             void* stream) {
  const int N = window * window;
  if (heads <= 0 || C % heads || (C / heads) % 8 || N % 8 || H % window || W % window ||
      rows <= 0 || rows % 8 || N % rows || (ln && m1 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AttnBwd p{x, g, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, static_cast<const float*>(m1),
            static_cast<const float*>(bias), dx, xn_s, go_s, o_s, do_s, dqkv_s,
            static_cast<float*>(dbias_part), static_cast<float*>(ln_part),
            H, W, C, heads, window, shift, rows, eps, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return ln ? attn_bwd_launch<float, true>(p, B, s)
                            : attn_bwd_launch<float, false>(p, B, s);
  if (dtype == 1) return ln ? attn_bwd_launch<__nv_bfloat16, true>(p, B, s)
                            : attn_bwd_launch<__nv_bfloat16, false>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
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

// out [len] = sum over n_parts of part [n_parts, len], in a fixed order.
extern "C" int swin_reduce(const void* part, int n_parts, long long len, void* out, void* stream) {
  if (n_parts <= 0 || len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  reduce_kernel<<<static_cast<unsigned>((len + 31) / 32), 256, 0, s>>>(
      static_cast<const float*>(part), n_parts, len, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
