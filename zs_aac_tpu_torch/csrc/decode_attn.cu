// Kernel K1: one decode step of causal multi-head attention over the int8 KV
// cache, for one new query per (batch row, head).
//
// Replaces the Pallas TPU kernel zs_aac_tpu/ops/decode_attn.py::_kernel and
// carries the numerics of zs_aac_tpu/models/gpt2.py::gpt2_step_q8 (lines
// 994-1007): the new token's k/v are quantized per vector exactly as
// _quantize_vec does, written into row `index` of the cache in place, and the
// query attends over rows 0..index with k-scales folded into the scores and
// v-scales folded into the probabilities. Rows past `index` are never read:
// the reference masks them to -1e9, which gives them an exact 0 weight.
//
// Two softmaxes, one instantiation each (the template flag kBf16Softmax): the
// reference's fp32 softmax, and the beam search's opt-in bf16 softmax of
// zs_aac_tpu/models/gpt2.py::gpt2_step_beam_q8 (lines 467-474, behind
// --bf16_softmax): the scores rounded to bf16, e = bf16(expf(bf16(s - max))),
// an fp32 sum of e, p = x.dtype(e) * x.dtype(1 / sum). The flag touches only
// the softmax (section 3); the fp32 instantiation is built as before.
//
// Bound: bytes. A call must read (index+1) int8 rows of K and of V plus their
// fp32 scales for every (b, h); it does ~2 flops per cache byte, far below the
// card's ridge point. GPT-2 124M's decode at B = 256 gives 3072 (b, h) of
// ~5 KB each (index 10..76, d = 64): 6 us of bytes at the H100 SXM's 3.35
// TB/s, so the call is set by how many loads are in flight and how long each
// (b, h) waits.
//
// Design (ops/decode_attn.py::decode_attn_plan picks kVec and the warps a
// block):
// - One warp per (b, h), `warps` of them a block, and no block-wide barrier:
//   every reduction is a warp shuffle, and a warp past B*H leaves at once.
// - A cache row is d / kVec lanes, each reading kVec int8 values in one load
//   (kVec = 16 at d = 64: a 16-byte load, 4 lanes a row, 8 rows a load
//   instruction of the warp); rpp = 32 / (d / kVec) rows a pass. A lane keeps
//   its kVec channels of q in registers; the partial dot products of a row
//   are summed over its lanes by shuffles.
// - The loads of a pass chunk (kU passes) are issued before the previous
//   chunk is used (two register buffers), K's first chunk before the new
//   row's quantization and V's first chunk before the softmax.
// - Two passes in flight and at most 80 registers a thread, so six blocks of
//   4 warps fit an SM: 3168 warps resident on 132 SMs, and the decode's 3072
//   (b, h) run in one wave. Four passes take 113 registers, 4 blocks an SM
//   (1.45 waves).
// - No L2 prefetch of the later rows: issued at the start for every row, it
//   made the call slower, not faster.
//
// The two counts (kU, kMinBlocks) were chosen by timing copies of this file
// built with other values, as examples/probe_decode_attn.py times K1. Mean over
// index 10..76 at B = 256 bf16, L2-cold, in a CUDA graph (NVIDIA H100 80GB
// HBM3, 700.00 W): 2 passes, 6 blocks: 15.9 us (80 registers, no spill); 3
// passes: 16.6; 4 passes capped at 6 blocks: 17.2 (spills); 4 passes
// uncapped: 23.8; capped at 8 blocks: 16.7 (spills). The kernel this
// replaced: 47.8 us. Byte bound: 5.96 us.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no fast-math: the quantization's division and
//        round-half-to-even and the softmax's expf must match the plain
//        PyTorch version bit for bit where the plain version is exact).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kU = 2;         // passes whose loads are in flight together
constexpr int kMaxWarps = 4;  // (b, h) a block at most
// blocks an SM the registers must allow: 65536 / (6 x 128) = 85, so 80 a thread
constexpr int kMinBlocks = 6;

template <typename T> __device__ __forceinline__ T store_t(float x);
template <> __device__ __forceinline__ float store_t<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 store_t<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round a float through the activation type, as the plain version's
// activation-dtype tensors do (the identity for fp32).
template <typename T> __device__ __forceinline__ float round_t(float x);
template <> __device__ __forceinline__ float round_t<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_t<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// kVec activation values from p, 16 bytes a load where p is aligned for it
// (a bf16 is the high half of its float: the conversion is exact).
template <typename T, int kVec>
__device__ __forceinline__ void load_act(const T* p, float (&v)[kVec]) {
  constexpr int kPer = 16 / sizeof(T);  // values of one 16-byte load
  if (kVec % kPer == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int i = 0; i < kVec / kPer; ++i) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + i * kPer);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (sizeof(T) == 4) {
          v[i * kPer + k] = __uint_as_float(w[k]);
        } else {
          v[i * kPer + 2 * k] = __uint_as_float(w[k] << 16);
          v[i * kPer + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = to_f(p[j]);
  }
}

// kVec int8 values of one cache row, as 32-bit words (byte j in word j / 4).
template <int kVec> struct Piece {
  uint32_t w[(kVec + 3) / 4];
};

template <int kVec> __device__ __forceinline__ Piece<kVec> load_piece(const int8_t* p) {
  Piece<kVec> r;
  if constexpr (kVec == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    r.w[0] = u.x; r.w[1] = u.y; r.w[2] = u.z; r.w[3] = u.w;
  } else if constexpr (kVec == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    r.w[0] = u.x; r.w[1] = u.y;
  } else if constexpr (kVec == 4) {
    r.w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (kVec == 2) {
    r.w[0] = *reinterpret_cast<const uint16_t*>(p);
  } else {
    r.w[0] = *reinterpret_cast<const uint8_t*>(p);
  }
  return r;
}

template <int kVec> __device__ __forceinline__ void store_piece(int8_t* p, const Piece<kVec>& r) {
  if constexpr (kVec == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
  } else if constexpr (kVec == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);
  } else if constexpr (kVec == 4) {
    *reinterpret_cast<uint32_t*>(p) = r.w[0];
  } else if constexpr (kVec == 2) {
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(r.w[0]);
  } else {
    *reinterpret_cast<uint8_t*>(p) = static_cast<uint8_t>(r.w[0]);
  }
}

// a where `first`, else b, word by word (selects in registers).
template <int kVec>
__device__ __forceinline__ Piece<kVec> pick(bool first, const Piece<kVec>& a, const Piece<kVec>& b) {
  Piece<kVec> r;
#pragma unroll
  for (int i = 0; i < (kVec + 3) / 4; ++i) r.w[i] = first ? a.w[i] : b.w[i];
  return r;
}

// Byte j of the piece as a float, exactly, without the conversion unit
// (a quarter of the FMA rate): the bytes are stored offset by 128 (w ^
// 0x80808080, see biased), byte_perm makes 2^23 + (b + 128), an fp32
// subtraction leaves b.
template <int kVec> __device__ __forceinline__ float byte_at(const Piece<kVec>& r, int j) {
  return __int_as_float(__byte_perm(r.w[j >> 2], 0x4B000000u, 0x7650u | (j & 3))) - 8388736.f;
}

template <int kVec> __device__ __forceinline__ Piece<kVec> biased(Piece<kVec> r) {
#pragma unroll
  for (int i = 0; i < (kVec + 3) / 4; ++i) r.w[i] ^= 0x80808080u;
  return r;
}

// Sum or max of v over the `lpr` lanes of this lane's row (lanes base ..
// base + lpr - 1); every lane of the row gets the same bits.
template <bool kMax>
__device__ __forceinline__ float row_reduce(float v, int lpr, int base) {
  if ((lpr & (lpr - 1)) == 0) {
    for (int o = 1; o < lpr; o <<= 1) {
      const float u = __shfl_xor_sync(kFull, v, o);
      v = kMax ? fmaxf(v, u) : v + u;
    }
    return v;
  }
  float r = __shfl_sync(kFull, v, base);
  for (int j = 1; j < lpr; ++j) {
    const float u = __shfl_sync(kFull, v, base + j);
    r = kMax ? fmaxf(r, u) : r + u;
  }
  return r;
}

// Sum of v over the rpp row groups at this lane's place c in its row; lanes
// c < lpr get it.
__device__ __forceinline__ float group_sum(float v, int lpr, int rpp, int c) {
  if ((lpr & (lpr - 1)) == 0) {
    for (int o = lpr; o < 32; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
    return v;
  }
  float r = __shfl_sync(kFull, v, c);
  for (int g = 1; g < rpp; ++g) r += __shfl_sync(kFull, v, g * lpr + c);
  return r;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// jnp.clip(jnp.round(x / scale), -127, 127): true division, half to even.
__device__ __forceinline__ uint32_t quantize(float x, float scale) {
  float r = rintf(x / scale);
  r = fminf(fmaxf(r, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(r)));
}

// _quantize_vec of the row whose kVec values this lane holds: the scale
// (every lane of the row gets it) and the lane's int8 piece (kVec < 4: a
// piece of one or two values).
template <int kVec>
__device__ __forceinline__ float quantize_row(const float (&x)[kVec], int lpr, int base,
                                              Piece<kVec>& out) {
  float a = 0.f;
#pragma unroll
  for (int j = 0; j < kVec; ++j) a = fmaxf(a, fabsf(x[j]));
  a = row_reduce<true>(a, lpr, base);
  const float scale = fmaxf(a / 127.f, 1e-8f);
#pragma unroll
  for (int i = 0; i < (kVec + 3) / 4; ++i) out.w[i] = 0u;
#pragma unroll
  for (int j = 0; j < kVec; ++j) out.w[j >> 2] |= quantize(x[j], scale) << (8 * (j & 3));
  return scale;
}

// The same for kVec >= 4, spread over the warp: lane l quantizes the
// 4-element groups l, l + 32, ... of the row (4 divisions a group instead of
// kVec a lane), then gathers the words of its own piece by shuffles.
constexpr int kMaxSlots = 4;  // 4-element groups a lane quantizes: d <= 512
template <typename T, int kVec>
__device__ __forceinline__ float quantize_spread(const T* x, int d, int c, Piece<kVec>& out) {
  const int lane = threadIdx.x & 31, slots = (d + 127) / 128;
  float v[kMaxSlots][4];
  float a = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s) {
    if (s >= slots) break;  // the same for the whole warp
    const int e = 4 * (lane + 32 * s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[s][i] = e < d ? to_f(x[e + i]) : 0.f;
      a = fmaxf(a, fabsf(v[s][i]));
    }
  }
  a = warp_max(a);
  const float scale = fmaxf(a / 127.f, 1e-8f);
  uint32_t w[kMaxSlots] = {};
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s) {
    if (s >= slots) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) w[s] |= quantize(v[s][i], scale) << (8 * i);
  }
#pragma unroll
  for (int k = 0; k < kVec / 4; ++k) {
    const int grp = c * (kVec / 4) + k;  // the row's 4-element group of the piece's word k
    uint32_t r = 0u;
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s) {
      if (s >= slots) break;
      const uint32_t u = __shfl_sync(kFull, w[s], grp & 31);
      if ((grp >> 5) == s) r = u;
    }
    out.w[k] = r;
  }
  return scale;
}

template <typename T, int kVec, bool kBf16Softmax>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
decode_attn_q8_kernel(const T* __restrict__ q, const T* __restrict__ kn,
                      const T* __restrict__ vn, int64_t q_sb, int64_t k_sb,
                      int64_t v_sb, int8_t* __restrict__ ck,
                      int8_t* __restrict__ cv, float* __restrict__ sk,
                      float* __restrict__ sv, T* __restrict__ o, int BH, int H,
                      int T_len, int d, int index, float sqrt_d) {
  extern __shared__ float smem[];
  const int n = index + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.x * (blockDim.x >> 5) + warp;
  if (bh >= BH) return;  // the whole warp: nothing below waits on other warps
  float* strip = smem + warp * n;  // scores, then probabilities, of rows 0..index
  const int b = bh / H, h = bh % H;
  const int lpr = d / kVec, rpp = 32 / lpr;  // lanes a row, rows a pass
  const int rg = lane / lpr, c = lane - rg * lpr, base = rg * lpr;
  const bool active = rg < rpp;  // lanes past rpp * lpr hold no row
  const int passes = (n + rpp - 1) / rpp;
  const int64_t row0 = static_cast<int64_t>(bh) * T_len;
  int8_t* ckr = ck + row0 * d + c * kVec;  // the lane's piece of row 0
  int8_t* cvr = cv + row0 * d + c * kVec;
  const float* skr = sk + row0;
  const float* svr = sv + row0;

  // The lane's channels of q (every row group holds the same ones).
  float qv[kVec];
  load_act<T, kVec>(q + b * q_sb + h * d + c * kVec, qv);

  // One pass chunk's pieces of K or V (and the row scales of K) into `buf`;
  // row `index` and rows past it are not read.
  auto load_chunk = [&](const int8_t* rows, const float* scales, int p0, Piece<kVec> (&buf)[kU],
                        float (&sc)[kU]) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = (p0 + u) * rpp + rg;
      if (active && t < index) {
        buf[u] = load_piece<kVec>(rows + static_cast<int64_t>(t) * d);
        if (scales != nullptr) sc[u] = scales[t];
      } else {
        buf[u] = Piece<kVec>{};
      }
    }
  };

  Piece<kVec> cur[kU], nxt[kU];
  float csc[kU] = {}, nsc[kU] = {};
  load_chunk(ckr, skr, 0, cur, csc);

  // 1. Quantize the new token's k and v (_quantize_vec); row `index` comes
  // from these registers below and is stored at the end.
  Piece<kVec> kq, vq;
  float ks, vs;
  if constexpr (kVec >= 4) {
    ks = quantize_spread<T, kVec>(kn + b * k_sb + h * d, d, c, kq);
    vs = quantize_spread<T, kVec>(vn + b * v_sb + h * d, d, c, vq);
  } else {
    float kx[kVec], vx[kVec];
    load_act<T, kVec>(kn + b * k_sb + h * d + c * kVec, kx);
    load_act<T, kVec>(vn + b * v_sb + h * d + c * kVec, vx);
    ks = quantize_row<kVec>(kx, lpr, base, kq);
    vs = quantize_row<kVec>(vx, lpr, base, vq);
  }

  // 2. Scores over rows 0..index: (q . k8) * (k_scale / sqrt(d)).
  for (int p0 = 0; p0 < passes; p0 += kU) {
    if (p0 + kU < passes) load_chunk(ckr, skr, p0 + kU, nxt, nsc);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = (p0 + u) * rpp + rg;
      if (p0 + u >= passes) break;  // the same for the whole warp
      const Piece<kVec> piece = biased(pick(t == index, kq, cur[u]));
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc += qv[j] * byte_at<kVec>(piece, j);
      acc = row_reduce<false>(acc, lpr, base);
      if (active && c == 0 && t < n) {
        const float scale = t == index ? ks : csc[u];
        strip[t] = round_t<T>(round_t<T>(acc) * round_t<T>(scale / sqrt_d));
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      cur[u] = nxt[u];
      csc[u] = nsc[u];
    }
  }
  load_chunk(cvr, nullptr, 0, cur, csc);  // V's first chunk, in flight over the softmax
  __syncwarp();

  // 3. The softmax; v-scales folded into the probabilities.
  if constexpr (kBf16Softmax) {
    // Every step but the fp32 sum rounds to bf16, as the reference's bf16
    // tensors do (the max of bf16 values is exact).
    using bf16 = __nv_bfloat16;
    float m = -INFINITY;
    for (int t = lane; t < n; t += 32) {
      const float x = round_t<bf16>(strip[t]);
      strip[t] = x;
      m = fmaxf(m, x);
    }
    m = warp_max(m);
    float s = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float e = round_t<bf16>(expf(round_t<bf16>(strip[t] - m)));
      strip[t] = e;
      s += e;
    }
    s = warp_sum(s);
    const float r = round_t<T>(1.f / s);
    for (int t = lane; t < n; t += 32)
      strip[t] = round_t<T>(round_t<T>(strip[t] * r) * (t == index ? vs : svr[t]));
  } else {
    float m = -INFINITY;
    for (int t = lane; t < n; t += 32) m = fmaxf(m, strip[t]);
    m = warp_max(m);
    float s = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float e = expf(strip[t] - m);
      strip[t] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int t = lane; t < n; t += 32)
      strip[t] = round_t<T>((strip[t] / s) * (t == index ? vs : svr[t]));
  }
  __syncwarp();

  // 4. o = sum_t p_t * v8[t]: kVec channels a lane over its rows, then the
  // row groups summed in a fixed order.
  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
  for (int p0 = 0; p0 < passes; p0 += kU) {
    if (p0 + kU < passes) load_chunk(cvr, nullptr, p0 + kU, nxt, nsc);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = (p0 + u) * rpp + rg;
      if (active && t < n) {
        const Piece<kVec> piece = biased(pick(t == index, vq, cur[u]));
        const float pt = strip[t];
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[j] += pt * byte_at<kVec>(piece, j);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) cur[u] = nxt[u];
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = group_sum(acc[j], lpr, rpp, c);

  if (lane < lpr) {
    T* out = o + static_cast<int64_t>(bh) * d + c * kVec;
#pragma unroll
    for (int j = 0; j < kVec; ++j) out[j] = store_t<T>(acc[j]);
    // 5. Commit row `index` and its scales, after every read of the cache.
    store_piece<kVec>(ckr + static_cast<int64_t>(index) * d, kq);
    store_piece<kVec>(cvr + static_cast<int64_t>(index) * d, vq);
    if (lane == 0) {
      sk[row0 + index] = ks;
      sv[row0 + index] = vs;
    }
  }
}

template <typename T, int kVec, bool kBf16Softmax>
int launch(int warps, const void* q, const void* kn, const void* vn, long long q_sb,
           long long k_sb, long long v_sb, void* ck, void* cv, void* sk, void* sv, void* o,
           int B, int H, int T_len, int d, int index, float sqrt_d, cudaStream_t s) {
  const int BH = B * H;
  const dim3 grid((BH + warps - 1) / warps);
  const size_t smem = sizeof(float) * warps * (index + 1);
  decode_attn_q8_kernel<T, kVec, kBf16Softmax><<<grid, warps * 32, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn), static_cast<const T*>(vn), q_sb,
      k_sb, v_sb, static_cast<int8_t*>(ck), static_cast<int8_t*>(cv), static_cast<float*>(sk),
      static_cast<float*>(sv), static_cast<T*>(o), BH, H, T_len, d, index, sqrt_d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kBf16Softmax>
int launch_vec(int vec, int warps, const void* q, const void* kn, const void* vn,
               long long q_sb, long long k_sb, long long v_sb, void* ck, void* cv, void* sk,
               void* sv, void* o, int B, int H, int T_len, int d, int index, float sqrt_d,
               cudaStream_t s) {
#define K1_LAUNCH(V)                                                                        \
  return launch<T, V, kBf16Softmax>(warps, q, kn, vn, q_sb, k_sb, v_sb, ck, cv, sk, sv, o, B, H, T_len, d, \
                      index, sqrt_d, s)
  switch (vec) {
    case 16: K1_LAUNCH(16);
    case 8: K1_LAUNCH(8);
    case 4: K1_LAUNCH(4);
    case 2: K1_LAUNCH(2);
    case 1: K1_LAUNCH(1);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K1_LAUNCH
}

template <bool kBf16Softmax>
int launch_dtype(int dtype, int vec, int warps, const void* q, const void* kn, const void* vn,
                 long long q_sb, long long k_sb, long long v_sb, void* ck, void* cv, void* sk,
                 void* sv, void* o, int B, int H, int T_len, int d, int index, float sqrt_d,
                 cudaStream_t s) {
  if (dtype == 0)
    return launch_vec<float, kBf16Softmax>(vec, warps, q, kn, vn, q_sb, k_sb, v_sb, ck, cv, sk,
                                           sv, o, B, H, T_len, d, index, sqrt_d, s);
  if (dtype == 1)
    return launch_vec<__nv_bfloat16, kBf16Softmax>(vec, warps, q, kn, vn, q_sb, k_sb, v_sb, ck,
                                                   cv, sk, sv, o, B, H, T_len, d, index, sqrt_d,
                                                   s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k_new, v_new and o). softmax: 0 =
// fp32, 1 = the bf16 softmax. vec: int8 values a lane reads of a cache row
// (16, 8, 4, 2 or 1, dividing d, d / vec <= 32); warps: (b, h) a block
// (decode_attn_plan). Returns the launch's cudaGetLastError() as an int
// (0 = success).
extern "C" int decode_attn_q8(int dtype, int softmax, int vec, int warps, const void* q,
                              const void* kn, const void* vn, long long q_sb, long long k_sb,
                              long long v_sb, void* ck, void* cv, void* sk, void* sv, void* o,
                              int B, int H, int T_len, int d, int index, float sqrt_d,
                              void* stream) {
  if (vec <= 0 || d % vec || d / vec > 32 || warps < 1 || warps > kMaxWarps || B <= 0 ||
      H <= 0 || index < 0 || index >= T_len)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (softmax == 0)
    return launch_dtype<false>(dtype, vec, warps, q, kn, vn, q_sb, k_sb, v_sb, ck, cv, sk, sv, o,
                               B, H, T_len, d, index, sqrt_d, s);
  if (softmax == 1)
    return launch_dtype<true>(dtype, vec, warps, q, kn, vn, q_sb, k_sb, v_sb, ck, cv, sk, sv, o,
                              B, H, T_len, d, index, sqrt_d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
