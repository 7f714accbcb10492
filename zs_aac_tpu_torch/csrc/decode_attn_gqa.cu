// Kernel K1g: one decode step of grouped-query attention over the int8 KV
// cache, for one new token a batch row: RoPE of q and k, the new k/v row's
// quantization and commit, and the attention over the sliding window
// lo..index, in one launch a layer.
//
// Replaces no TPU kernel: on the TPU XLA fused the int8-cache step of
// zs_aac_tpu/models/mistral.py::mistral_step into its neighbours. On the card
// the same step (ops/decode_attn_gqa.py::decode_attn_gqa_q8_plain) ran as ~40
// ATen kernels a layer, casting the whole int8 window to fp32 twice (up to
// 612 MB written a tensor a layer at Mistral-7B's B = 2,048).
//
// Numerics, those of the plain step: q and k rotated in the activation dtype,
// bf16(bf16(x * cos) + bf16(rot * sin)) (in fp32 the same three operations,
// unrounded); the new k and v quantized per vector exactly as
// ops/quant.py::quantize_vec (abs-max, / 127, max(., 1e-8), a true division,
// round half to even, clip); scores s_t = (q . k8_t) * (k_scale_t / sqrt(d))
// in fp32, the new row's from its quantized values; an fp32 softmax;
// w_t = dtype(p_t * v_scale_t); o = dtype(sum_t w_t v8_t) with an fp32 sum.
// Kernel and plain step differ only in summation order (no fast-math: the
// division, rintf and expf must be the IEEE ones).
//
// Bound: bytes. A call reads rows lo..index-1 of int8 K and V with their fp32
// scales for every (b, kv head) and writes row `index`: 2 d + 8 bytes a row,
// and 4 d flops a row a query head (~8 flops per cache byte at 4 query heads,
// far below the card's ridge). Mistral-7B's cell at B = 2,048: 16,384
// (b, kv head) of 14-73 rows.
//
// Design: a warp per (b, kv head), a few warps a block, no barrier. Each
// (b, kv head) is a short chain of dependent steps (load q, k, v; rotate and
// quantize; scores; softmax; output), so the card is kept busy by many of
// them in flight at once: few registers a thread (at most 64, 32 warps an
// SM), and no shared memory but the warp's scores.
// - The warp's kRep query heads share every int8 row and scale it reads, so
//   each is read once per kv head, not once per query head.
// - 8 bytes a lane: a row's d bytes over lpr = d / 8 lanes, 32 / lpr rows a
//   pass; each lane holds its 8 channels of the kRep rotated q in fp32
//   registers. kUnroll passes' loads are issued before any is used (an L2
//   prefetch of the window at the start measured slower: more so of K and V
//   than of V alone).
// - The new row: the first row group rotates and quantizes k, the second
//   quantizes v; each keeps its row in registers for the new row's score
//   (first group) and output (second group), and commits it to the cache
//   last.
// - Scores: the kRep partial dot products are summed over the row's lanes
//   by a transposing butterfly (each step halves the values a lane holds;
//   per-head sums where a row has fewer lanes than heads), into the warp's
//   strip of shared memory [n][kRep]; the window's k scales come in 32 at a
//   time, a lane each, and go to the rows by shuffles.
// - The softmax of the whole window from the strip (a plain softmax, not an
//   online rescaling), then o: kRep x 8 sums a lane over its rows, summed
//   over the row groups by shuffles in a fixed order.
// - The int8 values become floats without the conversion unit: the bytes are
//   offset by 128 (w ^ 0x80808080), byte_perm makes 2^23 + (b + 128) and an
//   fp32 subtraction leaves b (as K1, csrc/decode_attn.cu).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kVec = 8;             // int8 values a lane reads of a row
constexpr int kMaxWarps = 4;        // warps a block: one (b, kv head) each
constexpr int kUnroll = 4;          // row passes whose loads are in flight together
constexpr int kMinBlocks = 8;       // blocks an SM: at most 64 registers a thread
constexpr int kSmemMax = 232448;    // dynamic shared memory a block may opt into

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// A float rounded through the activation type (the identity for fp32).
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

// kVec activation values from p as floats, 16 bytes a load where p is aligned
// for it (a bf16 is the high half of its float: the conversion is exact).
template <typename T>
__device__ __forceinline__ void load_act(const T* p, float (&v)[kVec]) {
  constexpr int kPer = 16 / sizeof(T);  // values of one 16-byte load
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
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

// kVec floats to p in the activation type.
template <typename T>
__device__ __forceinline__ void store_act(T* p, const float (&v)[kVec]) {
  if constexpr (sizeof(T) == 2) {
    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
        w[k] = *reinterpret_cast<const uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) p[j] = from_f<T>(v[j]);
}

// Channels c0 .. c0 + kVec - 1 of the head row x rotated with the pieces cf,
// sf of cos and sin (rotate-half: rot_j = -x[j + d/2] below d/2, x[j - d/2]
// above), as models/mistral.py's RoPE computes them in T.
template <typename T>
__device__ __forceinline__ void rope_piece(const T* x, const float (&cf)[kVec],
                                           const float (&sf)[kVec], int c0, int d,
                                           float (&out)[kVec]) {
  const int half = d >> 1;
  float xv[kVec], pv[kVec];
  load_act<T>(x + c0, xv);
  if (half % kVec == 0) {  // the piece lies on one side of d/2
    load_act<T>(x + (c0 < half ? c0 + half : c0 - half), pv);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) pv[j] = to_f(x[c0 + j < half ? c0 + j + half : c0 + j - half]);
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float rot = c0 + j < half ? -pv[j] : pv[j];
    out[j] = round_t<T>(__fadd_rn(round_t<T>(__fmul_rn(xv[j], cf[j])),
                                  round_t<T>(__fmul_rn(rot, sf[j]))));
  }
}

// clip(round_half_even(x / scale), -127, 127) as an int8.
__device__ __forceinline__ int8_t quantize(float x, float scale) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(r));
}

// kVec int8 values of a row, as two words offset by 128 for byte_at.
struct Piece {
  uint32_t w[2];
};

__device__ __forceinline__ Piece load_piece(const int8_t* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return Piece{{u.x ^ 0x80808080u, u.y ^ 0x80808080u}};
}

// Byte j of an offset piece as a float, exactly.
__device__ __forceinline__ float byte_at(const Piece& r, int j) {
  return __int_as_float(__byte_perm(r.w[j >> 2], 0x4B000000u, 0x7650u | (j & 3))) - 8388736.f;
}

// Max of v over the lpr lanes of this lane's row (a power of two).
__device__ __forceinline__ float row_max(float v, int lpr) {
  for (int o = 1; o < lpr; o <<= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Sums a[0..kRep) over the row's lpr lanes (a power of two). Where lpr >=
// kRep each butterfly step halves the values a lane holds, so the lane ends
// with the sum of head `head` in a[0]; otherwise (`all`) every lane of the
// row ends with every head's sum in a[].
template <int kRep>
__device__ __forceinline__ void heads_sum(float (&a)[kRep], int lpr, int c, int& head,
                                          bool& all) {
  head = 0;
  all = lpr < kRep;
  if (all) {
#pragma unroll
    for (int h = 0; h < kRep; ++h)
      for (int o = 1; o < lpr; o <<= 1) a[h] += __shfl_xor_sync(kFull, a[h], o);
    return;
  }
  int o = lpr >> 1;
#pragma unroll
  for (int v = kRep; v > 1; v >>= 1) {
    const bool hi = (c & o) != 0;
#pragma unroll
    for (int i = 0; i < v / 2; ++i) {
      const float keep = hi ? a[i + v / 2] : a[i];
      const float send = hi ? a[i] : a[i + v / 2];
      a[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
    head = 2 * head + hi;
    o >>= 1;
  }
  for (; o > 0; o >>= 1) a[0] += __shfl_xor_sync(kFull, a[0], o);
}

// The scores of one row from the lane's partial dot products acc: summed over
// the row's lanes, times the row's k scale over sqrt(d) (sc), into strip row
// `t` where `live`.
template <int kRep>
__device__ __forceinline__ void put_scores(float (&acc)[kRep], int lpr, int c, bool live,
                                           float sc, float* strip_t) {
  int head;
  bool all;
  heads_sum<kRep>(acc, lpr, c, head, all);
  if (!live) return;
  if (all) {
    if (c == 0) {
#pragma unroll
      for (int h = 0; h < kRep; ++h) strip_t[h] = __fmul_rn(acc[h], sc);
    }
  } else if ((c & (lpr / kRep - 1)) == 0) {
    strip_t[head] = __fmul_rn(acc[0], sc);
  }
}

template <int kRep>
__device__ __forceinline__ void dot(const float (&qv)[kRep][kVec], const Piece& pc,
                                    float (&acc)[kRep]) {
#pragma unroll
  for (int h = 0; h < kRep; ++h) acc[h] = 0.f;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float kf = byte_at(pc, j);
#pragma unroll
    for (int h = 0; h < kRep; ++h) acc[h] = fmaf(qv[h][j], kf, acc[h]);
  }
}

template <int kRep>
__device__ __forceinline__ void axpy(const float* w_t, const Piece& pc,
                                     float (&acc)[kRep][kVec]) {
  float w[kRep];
#pragma unroll
  for (int h = 0; h < kRep; ++h) w[h] = w_t[h];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float vf = byte_at(pc, j);
#pragma unroll
    for (int h = 0; h < kRep; ++h) acc[h][j] = fmaf(w[h], vf, acc[h][j]);
  }
}

// A warp's strip of scores in shared memory: n rows of kRep floats, rounded
// to 16 bytes. ops/decode_attn_gqa.py::_strip_bytes is the same.
__host__ __device__ __forceinline__ int strip_floats(int n, int rep) {
  return (n * rep + 3) & ~3;
}

template <typename T, int kRep>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
decode_attn_gqa_q8_kernel(const T* __restrict__ q, const T* __restrict__ kn,
                          const T* __restrict__ vn, int64_t q_sb, int64_t k_sb, int64_t v_sb,
                          const T* __restrict__ cs, const T* __restrict__ sn,
                          int8_t* __restrict__ ck, int8_t* __restrict__ cv,
                          float* __restrict__ sk, float* __restrict__ sv, T* __restrict__ o,
                          int BG, int KV, int T_len, int d, int index, int lo, float sqrt_d) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bg = blockIdx.x * (blockDim.x >> 5) + warp;
  if (bg >= BG) return;  // the warp's own exit: nothing below waits on the block
  const int n = index - lo + 1, m = n - 1;  // window rows; the last (m) is the new one
  float* strip = smem + warp * strip_floats(n, kRep);
  const int b = bg / KV, g = bg - b * KV;

  // The lane's place: lpr lanes a row, rpw rows a pass; channels c * kVec ..
  const int lpr = d / kVec, rpw = 32 / lpr, rgp = lane / lpr, c = lane - rgp * lpr;
  const int64_t row0 = static_cast<int64_t>(bg) * T_len;
  const int8_t* kw = ck + (row0 + lo) * d + c * kVec;  // the lane's bytes of the window's row 0
  const int8_t* vw = cv + (row0 + lo) * d + c * kVec;
  const float* skw = sk + row0 + lo;
  const float* svw = sv + row0 + lo;

  // 1. The rotated q of the kRep heads (every row group the same), and the
  // new row: the first row group rotates k, the second reads v; each
  // quantizes its row and keeps it (committed to the cache at the end, so
  // that no load of the window waits behind the store).
  float cf[kVec], sf[kVec];
  load_act<T>(cs + c * kVec, cf);
  load_act<T>(sn + c * kVec, sf);
  float qv[kRep][kVec];
  const T* qg = q + b * q_sb + static_cast<int64_t>(g) * kRep * d;
#pragma unroll
  for (int h = 0; h < kRep; ++h) rope_piece<T>(qg + h * d, cf, sf, c * kVec, d, qv[h]);
  float x[kVec];
  if (rgp == 0) {
    rope_piece<T>(kn + b * k_sb + g * d, cf, sf, c * kVec, d, x);
  } else if (rgp == 1) {
    load_act<T>(vn + b * v_sb + g * d + c * kVec, x);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) x[j] = 0.f;
  }
  float a = 0.f;
#pragma unroll
  for (int j = 0; j < kVec; ++j) a = fmaxf(a, fabsf(x[j]));
  const float scale = fmaxf(__fdiv_rn(row_max(a, lpr), 127.f), 1e-8f);
  uint32_t nw[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    nw[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(quantize(x[j], scale)))
                  << (8 * (j & 3));
  const Piece fresh{{nw[0] ^ 0x80808080u, nw[1] ^ 0x80808080u}};

  // 2. Scores of the cached rows, 32 at a time (a k scale a lane), then the
  // new row's (the first row group's).
  for (int c0 = 0; c0 < m; c0 += 32) {
    const int rows = min(32, m - c0);
    const float sl = lane < rows ? __fdiv_rn(skw[c0 + lane], sqrt_d) : 0.f;
    for (int r0 = 0; r0 < rows; r0 += kUnroll * rpw) {  // the same trip count for the warp
      Piece pc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * rpw + rgp;
        pc[u] = r < rows ? load_piece(kw + static_cast<int64_t>(c0 + r) * d) : Piece{{0u, 0u}};
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * rpw + rgp;
        float acc[kRep];
        dot<kRep>(qv, pc[u], acc);
        const float sc = __shfl_sync(kFull, sl, r & 31);
        put_scores<kRep>(acc, lpr, c, r < rows, sc, strip + (c0 + r) * kRep);
      }
    }
  }
  {
    float acc[kRep];
    dot<kRep>(qv, fresh, acc);
    put_scores<kRep>(acc, lpr, c, rgp == 0, __fdiv_rn(scale, sqrt_d), strip + m * kRep);
  }
  __syncwarp();

  // 3. The softmax of each head over the window, v scales folded in:
  // w_t = dtype(p_t * v_scale_t).
  float mx[kRep], den[kRep];
#pragma unroll
  for (int h = 0; h < kRep; ++h) mx[h] = -INFINITY, den[h] = 0.f;
  for (int t = lane; t < n; t += 32)
#pragma unroll
    for (int h = 0; h < kRep; ++h) mx[h] = fmaxf(mx[h], strip[t * kRep + h]);
#pragma unroll
  for (int h = 0; h < kRep; ++h)
    for (int o2 = 16; o2 > 0; o2 >>= 1) mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], o2));
  for (int t = lane; t < n; t += 32)
#pragma unroll
    for (int h = 0; h < kRep; ++h) {
      const float e = expf(__fsub_rn(strip[t * kRep + h], mx[h]));
      strip[t * kRep + h] = e;
      den[h] += e;
    }
#pragma unroll
  for (int h = 0; h < kRep; ++h)
    for (int o2 = 16; o2 > 0; o2 >>= 1) den[h] += __shfl_xor_sync(kFull, den[h], o2);
  const float fresh_sv = __shfl_sync(kFull, scale, lpr);  // the second row group's: v's
  for (int t = lane; t < n; t += 32) {
    const float vs = t < m ? svw[t] : fresh_sv;
#pragma unroll
    for (int h = 0; h < kRep; ++h)
      strip[t * kRep + h] = round_t<T>(__fmul_rn(__fdiv_rn(strip[t * kRep + h], den[h]), vs));
  }
  __syncwarp();

  // 4. o = sum_t w_t v8_t: kRep x kVec sums a lane over its rows (the new
  // row the second row group's), then over the row groups.
  float acc[kRep][kVec];
#pragma unroll
  for (int h = 0; h < kRep; ++h)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[h][j] = 0.f;
  for (int r0 = 0; r0 < m; r0 += kUnroll * rpw) {
    Piece pc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * rpw + rgp;
      pc[u] = r < m ? load_piece(vw + static_cast<int64_t>(r) * d) : Piece{{0u, 0u}};
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * rpw + rgp;
      if (r < m) axpy<kRep>(strip + r * kRep, pc[u], acc);
    }
  }
  if (rgp == 1) axpy<kRep>(strip + m * kRep, fresh, acc);
#pragma unroll
  for (int h = 0; h < kRep; ++h)
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      for (int o2 = lpr; o2 < 32; o2 <<= 1) acc[h][j] += __shfl_xor_sync(kFull, acc[h][j], o2);
  if (rgp == 0) {
    T* og = o + static_cast<int64_t>(b) * KV * kRep * d + static_cast<int64_t>(g) * kRep * d;
#pragma unroll
    for (int h = 0; h < kRep; ++h) store_act<T>(og + h * d + c * kVec, acc[h]);
  }
  // 5. The new row and its scale into row `index` of the cache.
  if (rgp < 2) {
    *reinterpret_cast<uint2*>((rgp == 0 ? ck : cv) + (row0 + index) * d + c * kVec) =
        make_uint2(nw[0], nw[1]);
    if (c == 0) (rgp == 0 ? sk : sv)[row0 + index] = scale;
  }
}

template <typename T, int kRep>
int launch(int warps, const void* q, const void* kn, const void* vn, long long q_sb,
           long long k_sb, long long v_sb, const void* cs, const void* sn, void* ck, void* cv,
           void* sk, void* sv, void* o, int BG, int KV, int T_len, int d, int index, int lo,
           float sqrt_d, cudaStream_t s) {
  const int smem = warps * strip_floats(index - lo + 1, kRep) * 4;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = decode_attn_gqa_q8_kernel<T, kRep>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<(BG + warps - 1) / warps, warps * 32, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn), static_cast<const T*>(vn), q_sb,
      k_sb, v_sb, static_cast<const T*>(cs), static_cast<const T*>(sn),
      static_cast<int8_t*>(ck), static_cast<int8_t*>(cv), static_cast<float*>(sk),
      static_cast<float*>(sv), static_cast<T*>(o), BG, KV, T_len, d, index, lo, sqrt_d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, cos, sin, o). q [B, H d], k and
// v [B, KV d], each row a stride apart (elements) and contiguous within; cos,
// sin [d]; ck, cv [B KV, T_len, d] int8 and sk, sv [B KV, T_len] fp32,
// contiguous; o [B, H d] contiguous. H = rep KV, rep 2 or 4; d 8, 16, 32, 64
// or 128; warps (1-4): decode_attn_gqa_plan. Returns the launch's
// cudaGetLastError() as an int (0 = success).
extern "C" int decode_attn_gqa_q8(int dtype, int rep, int warps, const void* q, const void* kn,
                                  const void* vn, long long q_sb, long long k_sb, long long v_sb,
                                  const void* cs, const void* sn, void* ck, void* cv, void* sk,
                                  void* sv, void* o, int B, int KV, int T_len, int d, int index,
                                  int lo, float sqrt_d, void* stream) {
  if ((d != 8 && d != 16 && d != 32 && d != 64 && d != 128) || warps < 1 ||
      warps > kMaxWarps || B <= 0 || KV <= 0 || static_cast<long long>(B) * KV >= (1LL << 31) ||
      lo < 0 || lo > index || index >= T_len)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BG = B * KV;
#define K1G_LAUNCH(T, R)                                                                     \
  return launch<T, R>(warps, q, kn, vn, q_sb, k_sb, v_sb, cs, sn, ck, cv, sk, sv, o, BG, KV, \
                      T_len, d, index, lo, sqrt_d, s)
  if (dtype == 0 && rep == 2) K1G_LAUNCH(float, 2);
  if (dtype == 0 && rep == 4) K1G_LAUNCH(float, 4);
  if (dtype == 1 && rep == 2) K1G_LAUNCH(__nv_bfloat16, 2);
  if (dtype == 1 && rep == 4) K1G_LAUNCH(__nv_bfloat16, 4);
#undef K1G_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
