// Kernel K2: the log-mel frontend, wave [B, T] fp32 -> [B, 1, F, n_mels] fp32.
//
// Replaces the Pallas TPU kernel zs_aac_tpu/ops/logmel.py::_logmel_kernel
// (:192) and computes the function of log_mel_xla (the port's log_mel_plain):
// reflect padding by n_fft/2 (the reflected index is computed here, so no
// padded copy of the wave exists), frames every `hop` samples, a periodic
// Hann window, the power spectrum |rfft|^2, a Slaney mel filterbank and
// 10*log10(max(mel, amin)) - 10*log10(max(amin, ref)).
//
// Bound: bytes and fp32 FFT operations, nearly equal. A call must read the
// wave once and write the log-mel once (B=64, T=320000: 82 MB in, 16 MB out,
// 29 us at 3.35 TB/s); a real FFT costs ~2.5 n log2 n flops a frame, 1.9
// GFLOP a call with the power and the mel sums, 28 us at 67 TFLOP/s. The
// TPU kernel's DFT-as-two-matmuls fed the MXU; here it would cost 2 n^2 flops
// a frame, 100x an FFT, so the spectrum is an FFT on the CUDA cores in fp32
// (TF32 or bf16 tensor cores would round the leakage bins of a pure tone,
// 60-90 dB under its peak, by more than the 0.1 dB they are held to).
//
// Two instantiations (ops/logmel.py::logmel_plan picks one from the shapes):
//
// frames::kernel<N>, N = n_fft in 256..2048, against what held the first
// kernel back:
//  1. One block per frame (64,064 blocks of 5,120 butterflies at the main
//     path's shapes). Now a block takes a run of up to 16 consecutive frames
//     of one batch row, ceil(F / 16) x B blocks, and its warps a frame each.
//  2. A barrier-bound radix-2 FFT in shared memory, twiddles from device
//     memory. Now a warp packs its frame as an M = N/2-point complex FFT and
//     runs Stockham passes of radix-16 (radix-8 at N = 512) butterflies in
//     its lanes' registers, N/64 points a lane; the passes exchange through
//     the warp's own shared tile under __syncwarp, with no block-wide
//     barrier, and read their twiddles from a shared table (float64 on the
//     host, then rounded to fp32; no __sincosf).
//  3. A complex FFT of a real frame. Now the (even, odd) samples are the
//     real and imaginary parts of the M-point FFT, and a split step, fused
//     into the last pass, turns Z[k] and Z[M-k] into the power of the real
//     frame's bins k and M-k: half the work.
//  4. Every sample read ~3.2 times, a scalar load each, its reflect index
//     computed per element and scattered in bit-reversed order. Now the
//     block loads its span of (frames - 1) * hop + N samples once into shared
//     memory, in 16-byte loads where the row and the hop allow, and only a
//     block whose span crosses an end of the row reflects indices; the
//     warps read their frames from the span in natural order.
//  5. A serial mel stage on 64 of 256 threads, each walking its band's 3 to
//     47 bins with the filterbank read from device memory at a stride of
//     n_mels. Now the filterbank is packed once a block into shared memory
//     (each band's weights over its non-zero bins), each band is cut into
//     chunks of at most 9 bins, the lanes sum the chunks of all bands in
//     turn (the weights interleaved so that the lanes read neighbouring
//     words), and each band adds its chunks' sums in a fixed order.
//
// What bounds it now: the shared-memory pipe and the instruction issue, at
// about the same rate (examples/probe_logmel.py splits the time). Each pass
// but the last moves a frame's M complex values through the warp's tile, and
// the window, the twiddles and the filterbank are read from shared memory as
// well.
//
// radix2::kernel, every other power of two in [2, 4096]: the first kernel,
// one block of 256 threads per (frame, batch row), a radix-2 FFT in shared
// memory.
//
// Numerics: fp32 throughout (no fast-math: log10f and the FFT stay IEEE).
// The spectrum differs from torch.fft.rfft by summation order (~1e-6
// relative), which moves the log-mel by well under 0.01 dB wherever the mel
// power is above the fp32 FFT's rounding floor (~1e-12 of the frame's peak).
//
// K2_STOP (examples/probe_logmel.py's time split; 0 by default): 1 ends each
// block after the samples are loaded, 2 after the FFT (the frame-run kernel:
// after the power, which its last pass computes).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef K2_STOP
#define K2_STOP 0
#endif

namespace {

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

namespace radix2 {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
kernel(const float* __restrict__ wave, const float* __restrict__ win,
       const float2* __restrict__ tw, const float* __restrict__ mel_w,
       const int* __restrict__ mel_lo, const int* __restrict__ mel_hi,
       float* __restrict__ out, int T, int F, int n_fft, int log2n, int hop,
       int n_mels, float amin, float log_ref) {
  extern __shared__ float2 z[];  // [n_fft] complex spectrum, then power
  const int f = blockIdx.x, b = blockIdx.y;
  const int pad = n_fft / 2;
  const float* x = wave + static_cast<long long>(b) * T;

  // 1. Windowed frame, reflect-padded, stored in bit-reversed order.
  for (int j = threadIdx.x; j < n_fft; j += blockDim.x) {
    int idx = f * hop + j - pad;
    if (idx < 0) idx = -idx;
    if (idx >= T) idx = 2 * (T - 1) - idx;
    const int r = __brev(static_cast<unsigned>(j)) >> (32 - log2n);
    z[r] = make_float2(x[idx] * win[j], 0.f);
  }
  __syncthreads();
  if (K2_STOP == 1) return;

  // 2. Iterative radix-2 decimation-in-time FFT.
  for (int s = 1; s <= log2n; ++s) {
    const int half = 1 << (s - 1);
    const int step = n_fft >> s;  // twiddle stride for this stage
    for (int t = threadIdx.x; t < n_fft / 2; t += blockDim.x) {
      const int pos = t & (half - 1);
      const int i = ((t >> (s - 1)) << s) + pos;
      const int j = i + half;
      const float2 w = tw[pos * step];
      const float2 a = z[i], c = z[j];
      const float2 bw = make_float2(c.x * w.x - c.y * w.y, c.x * w.y + c.y * w.x);
      z[i] = make_float2(a.x + bw.x, a.y + bw.y);
      z[j] = make_float2(a.x - bw.x, a.y - bw.y);
    }
    __syncthreads();
  }
  if (K2_STOP == 2) return;

  // 3. Power of bins 0..n_fft/2, written over each bin's real part by the
  //    thread that read it.
  for (int k = threadIdx.x; k <= n_fft / 2; k += blockDim.x) {
    const float2 v = z[k];
    z[k].x = v.x * v.x + v.y * v.y;
  }
  __syncthreads();

  // 4. Mel bands over their non-zero bins, then dB.
  float* o = out + (static_cast<long long>(b) * F + f) * n_mels;
  for (int m = threadIdx.x; m < n_mels; m += blockDim.x) {
    float acc = 0.f;
    for (int k = mel_lo[m]; k < mel_hi[m]; ++k) acc = fmaf(z[k].x, mel_w[k * n_mels + m], acc);
    o[m] = 10.f * log10f(fmaxf(acc, amin)) - log_ref;
  }
}

}  // namespace radix2

namespace frames {

constexpr int kMaxWarps = 8;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may take
// Bins of a mel band one lane sums at a time (ops/logmel.py::_CHUNK): odd, so
// that the lanes' runs of bins, kChunk apart within a band, start on
// different banks.
constexpr int kChunk = 9;

// The block's shared memory, in this order (ops/logmel.py::_frames_smem adds
// up the same regions): the later Stockham passes' twiddles (fewer than M,
// padded to M); the split step's exp(-2 pi i k / N), k <= M/2; the window;
// the packed filterbank, [kChunk][n_chunks] (weight i of chunk c at
// i n_chunks + c, zeros past the chunk's length); the chunks (lo | len << 16)
// and each band's first chunk; each warp's FFT tile (M complex, one pad a
// 16; after the FFT the power of bins 0..M, then the chunk sums); the
// block's span of samples. Each region starts on 16 bytes.
struct Layout {
  int tw, stw, win, melw, chunks, first, tiles, span, total;
  __host__ __device__ Layout(int n, int n_mels, int n_chunks, int warps,
                             int run, int hop) {
    const int m = n / 2;
    int o = 0;
    tw = o;     o += align16(8 * m);
    stw = o;    o += align16(8 * (m / 2 + 1));
    win = o;    o += align16(4 * n);
    melw = o;   o += align16(4 * kChunk * n_chunks);
    chunks = o; o += align16(4 * n_chunks);
    first = o;  o += align16(4 * (n_mels + 1));
    tiles = o;  o += align16(warps * 8 * (m + m / 16));
    span = o;   o += align16(4 * ((run - 1) * hop + n));
    total = o;
  }
};

// Element e of a warp's tile, one pad slot after every 16: the first pass's
// writes (lanes 16 complex apart) then fall on distinct banks.
__device__ __forceinline__ int pad(int e) { return e + (e >> 4); }

// cp.async of 16 or 4 bytes from device memory to shared memory; copy_wait()
// waits for all of the thread's copies (a __syncthreads() must follow).
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src));
}
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src));
}
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// n 4-byte words from src to dst, all threads of the block.
__device__ __forceinline__ void copy_words(void* dst, const void* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    copy4(static_cast<float*>(dst) + i, static_cast<const float*>(src) + i);
  }
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * exp(-2 pi i k / 16), k in [0, 8): the internal twiddles of a radix-2..16
// DFT. k is a constant once the DFT's loops are unrolled.
__device__ __forceinline__ float2 mul_w16(float2 a, int k) {
  constexpr float c = 0.92387953251128676f, s = 0.38268343236508977f;
  constexpr float h = 0.70710678118654752f;
  switch (k) {
    case 0: return a;
    case 1: return cmul(a, make_float2(c, -s));
    case 2: return make_float2(h * (a.x + a.y), h * (a.y - a.x));
    case 3: return cmul(a, make_float2(s, -c));
    case 4: return make_float2(a.y, -a.x);
    case 5: return cmul(a, make_float2(-s, -c));
    case 6: return make_float2(h * (a.y - a.x), -h * (a.x + a.y));
    default: return cmul(a, make_float2(-c, -s));
  }
}

__host__ __device__ constexpr int bit_reverse(int i, int r) {
  int j = 0;
  for (int b = 1; b < r; b <<= 1, i >>= 1) j = (j << 1) | (i & 1);
  return j;
}

// One radix-2 stage (butterflies HALF apart) of an R-point decimation in
// frequency, then the next: every index is a template constant, so v stays
// in registers.
template <int R, int HALF>
__device__ __forceinline__ void dif_stages(float2* v) {
  if constexpr (HALF >= 1) {
#pragma unroll
    for (int i = 0; i < R; i += 2 * HALF) {
#pragma unroll
      for (int p = 0; p < HALF; ++p) {
        const float2 a = v[i + p], b = v[i + p + HALF];
        v[i + p] = make_float2(a.x + b.x, a.y + b.y);
        v[i + p + HALF] = mul_w16(make_float2(a.x - b.x, a.y - b.y), p * (8 / HALF));
      }
    }
    dif_stages<R, HALF / 2>(v);
  }
}

// R-point DFT of v in registers (R = 2..16), radix-2 decimation in
// frequency: natural order in, v[p] = X[bit_reverse(p, R)] out. The callers
// store v[p] at X's index, so no register is indexed at run time.
template <int R>
__device__ __forceinline__ void dft(float2* v) {
  dif_stages<R, R / 2>(v);
}

// The first Stockham pass (span Ns = 1, radix R) of the M-point FFT of
// z[n] = (x[2n] w[2n], x[2n+1] w[2n+1]), read from the frame's samples s;
// butterfly j = lane + 32 b takes z[j + r M/R] and writes tile[j R + r].
// `even`: s is 8-byte aligned (the frame starts on an even sample).
template <int M, int R>
__device__ __forceinline__ void first_pass(float2* tile, const float* s, const float* win,
                                           bool even, int lane) {
  constexpr int B = M / (32 * R);
  const float2* w2 = reinterpret_cast<const float2*>(win);
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = lane + 32 * b;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = j + r * (M / R);
      const float2 x = even ? reinterpret_cast<const float2*>(s)[n]
                            : make_float2(s[2 * n], s[2 * n + 1]);
      const float2 w = w2[n];
      v[r] = make_float2(x.x * w.x, x.y * w.y);
    }
    dft<R>(v);
#pragma unroll
    for (int p = 0; p < R; ++p) tile[pad(j * R + bit_reverse(p, R))] = v[p];
  }
  __syncwarp();
}

// A later Stockham pass (span NS, radix R), in place in the warp's tile: all
// reads before the first write. Butterfly j takes x[j + r M/R] times
// exp(-2 pi i (j mod NS) r / (NS R)), which the pass's twiddle table holds
// at tw[(r - 1) NS + j mod NS] (lanes read neighbouring entries), and
// writes its DFT to x[(j / NS) NS R + j mod NS + r NS].
template <int M, int R, int NS>
__device__ __forceinline__ void pass(float2* tile, const float2* tw, int lane) {
  constexpr int B = M / (32 * R);
  float2 v[B][R];
#pragma unroll
  for (int b = 0; b < B; ++b) {
#pragma unroll
    for (int r = 0; r < R; ++r) v[b][r] = tile[pad(lane + 32 * b + r * (M / R))];
  }
  __syncwarp();
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = lane + 32 * b, jm = j % NS;
#pragma unroll
    for (int r = 1; r < R; ++r) v[b][r] = cmul(v[b][r], tw[(r - 1) * NS + jm]);
    dft<R>(v[b]);
    const int d = (j / NS) * NS * R + jm;
#pragma unroll
    for (int p = 0; p < R; ++p) tile[pad(d + bit_reverse(p, R) * NS)] = v[b][p];
  }
  __syncwarp();
}

// The power of bins k and M - k (k <= M/2) into p[k] and p[m - k], from
// a = Z[k] and c = Z[M-k]: with Z the FFT of z, 2E = Z[k] + conj(Z[M-k]) and
// 2O = (Z[k] - conj(Z[M-k])) / i are the FFTs of the even and odd samples,
// and the real frame's bins are X[k] = E + W^k O, X[M-k] = conj(E - W^k O),
// W = exp(-2 pi i / N) (w = W^k from the split table).
__device__ __forceinline__ void pair_power(float2 a, float2 c, float2 w, float* p, int k, int m) {
  const float2 e = make_float2(a.x + c.x, a.y - c.y);
  const float2 wo = cmul(w, make_float2(a.y + c.y, c.x - a.x));
  const float2 x1 = make_float2(e.x + wo.x, e.y + wo.y);
  const float2 x2 = make_float2(e.x - wo.x, e.y - wo.y);
  p[k] = 0.25f * (x1.x * x1.x + x1.y * x1.y);
  p[m - k] = 0.25f * (x2.x * x2.x + x2.y * x2.y);
}

// The last Stockham pass (span NS = M/R, radix R) fused with the split step:
// butterfly j's outputs are Z[j + r NS], r < R, and the partner of each,
// Z[M - j - r NS], is output R-1-r of butterfly NS - j. Item t < NS/2 of the
// lanes takes butterflies t and NS - t; item 0 takes butterflies 0 and NS/2,
// each of which holds its own partners. Writes the power of bins 0..M over
// the tile's first M + 1 floats (all reads first).
template <int M, int R>
__device__ __forceinline__ void last_pass_power(float2* tile, const float2* tw,
                                                const float2* stw, int lane) {
  constexpr int NS = M / R, ITEMS = NS / 2, IB = (ITEMS + 31) / 32;
  float2 v[IB][2][R];
#pragma unroll
  for (int ib = 0; ib < IB; ++ib) {
    const int t = lane + 32 * ib;
    if (t < ITEMS) {
      const int j1 = t, j2 = t == 0 ? NS / 2 : NS - t;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        v[ib][0][r] = tile[pad(j1 + r * NS)];
        v[ib][1][r] = tile[pad(j2 + r * NS)];
      }
    }
  }
  __syncwarp();
  float* p = reinterpret_cast<float*>(tile);
#pragma unroll
  for (int ib = 0; ib < IB; ++ib) {
    const int t = lane + 32 * ib;
    if (t < ITEMS) {
      const int j1 = t, j2 = t == 0 ? NS / 2 : NS - t;
#pragma unroll
      for (int r = 1; r < R; ++r) {
        v[ib][0][r] = cmul(v[ib][0][r], tw[(r - 1) * NS + j1]);
        v[ib][1][r] = cmul(v[ib][1][r], tw[(r - 1) * NS + j2]);
      }
      dft<R>(v[ib][0]);
      dft<R>(v[ib][1]);
      // output r of a butterfly sits in v[bit_reverse(r, R)]
      const float2* z1 = v[ib][0];
      const float2* z2 = v[ib][1];
      if (t > 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float2 a = z1[bit_reverse(r, R)], c = z2[bit_reverse(R - 1 - r, R)];
          if (r < R / 2) {
            const int k = t + r * NS;
            pair_power(a, c, stw[k], p, k, M);
          } else {
            const int k = (R - r) * NS - t;
            pair_power(c, a, stw[k], p, k, M);
          }
        }
      } else {
        pair_power(z1[0], z1[0], stw[0], p, 0, M);
#pragma unroll
        for (int r = 1; r <= R / 2; ++r) {
          pair_power(z1[bit_reverse(r, R)], z1[bit_reverse(R - r, R)], stw[r * NS], p, r * NS, M);
        }
#pragma unroll
        for (int r = 0; r < R / 2; ++r) {
          const int k = NS / 2 + r * NS;
          pair_power(z2[bit_reverse(r, R)], z2[bit_reverse(R - 1 - r, R)], stw[k], p, k, M);
        }
      }
    }
  }
  __syncwarp();
}

// The passes after the first: radix RL while it fits, the last pass the
// remainder (ops/logmel.py::_radices is the same rule), fused with the
// split step. Each pass's twiddles follow the previous pass's, (R - 1) NS of
// them.
template <int M, int RL, int NS>
__device__ __forceinline__ void passes(float2* tile, const float2* tw, const float2* stw,
                                       int lane) {
  constexpr int R = M / NS < RL ? M / NS : RL;
  if constexpr (NS * R < M) {
    pass<M, R, NS>(tile, tw, lane);
    passes<M, RL, NS * R>(tile, tw + (R - 1) * NS, stw, lane);
  } else {
    last_pass_power<M, R>(tile, tw, stw, lane);
  }
}

// Mel bands and dB of one frame from its power p: the lanes take the chunks
// in turn (chunk c: kChunk bins from lo, weights past its length 0), then band
// m adds its chunks' sums in order.
__device__ __forceinline__ void mel_db(const float* p, float* part, const float* melw,
                                       const int* chunks, const int* first, int n_chunks,
                                       int n_mels, float* o, float amin, float log_ref,
                                       int lane) {
  for (int c = lane; c < n_chunks; c += 32) {
    const int ch = chunks[c];
    const float* pk = p + (ch & 0xffff);
    const int len = ch >> 16;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i < len) s = fmaf(pk[i], melw[i * n_chunks + c], s);
    }
    part[c] = s;
  }
  __syncwarp();
  for (int m = lane; m < n_mels; m += 32) {
    float acc = 0.f;
    for (int c = first[m]; c < first[m + 1]; ++c) acc += part[c];
    o[m] = 10.f * log10f(fmaxf(acc, amin)) - log_ref;
  }
  __syncwarp();
}

template <int N>
__global__ void __launch_bounds__(kMaxWarps * 32)
kernel(const float* __restrict__ wave, const float* __restrict__ win_g,
       const float2* __restrict__ tw_g, const float2* __restrict__ stw_g,
       const float* __restrict__ melw_g, const int* __restrict__ chunks_g,
       const int* __restrict__ first_g, float* __restrict__ out, int T, int F, int hop,
       int n_mels, int n_chunks, int run, int vec, float amin, float log_ref) {
  constexpr int M = N / 2, RL = M / 32 < 16 ? M / 32 : 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Layout lay(N, n_mels, n_chunks, warps, run, hop);
  const float2* tw = reinterpret_cast<const float2*>(smem + lay.tw);
  const float2* stw = reinterpret_cast<const float2*>(smem + lay.stw);
  const float* win = reinterpret_cast<const float*>(smem + lay.win);
  const float* melw = reinterpret_cast<const float*>(smem + lay.melw);
  const int* chunks = reinterpret_cast<const int*>(smem + lay.chunks);
  const int* first = reinterpret_cast<const int*>(smem + lay.first);
  float* span = reinterpret_cast<float*>(smem + lay.span);

  const int b = blockIdx.y, f0 = blockIdx.x * run;
  const int nf = min(run, F - f0);
  const int base = f0 * hop - N / 2, len = (nf - 1) * hop + N;
  copy_words(smem + lay.tw, tw_g, 2 * M);
  copy_words(smem + lay.stw, stw_g, 2 * (M / 2 + 1));
  copy_words(smem + lay.win, win_g, N);
  copy_words(smem + lay.melw, melw_g, kChunk * n_chunks);
  copy_words(smem + lay.chunks, chunks_g, n_chunks);
  copy_words(smem + lay.first, first_g, n_mels + 1);
  const float* x = wave + static_cast<long long>(b) * T;
  if (base >= 0 && base + len <= T) {
    if (vec == 4) {  // the row, the hop and the padding are multiples of 4 samples
      for (int i = 4 * threadIdx.x; i < len; i += 4 * blockDim.x) copy16(span + i, x + base + i);
    } else {
      copy_words(span, x + base, len);
    }
  } else {  // the span crosses an end of the row: reflect
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      int idx = base + i;
      if (idx < 0) idx = -idx;
      if (idx >= T) idx = 2 * (T - 1) - idx;
      copy4(span + i, x + idx);
    }
  }
  copy_wait();
  __syncthreads();
  if (K2_STOP == 1) return;

  float2* tile = reinterpret_cast<float2*>(smem + lay.tiles) + warp * (M + M / 16);
  float* part = reinterpret_cast<float*>(tile) + M + 1;
  for (int fl = warp; fl < nf; fl += warps) {
    first_pass<M, RL>(tile, span + fl * hop, win, ((fl * hop) & 1) == 0, lane);
    passes<M, RL, RL>(tile, tw, stw, lane);
    if (K2_STOP == 2) continue;
    mel_db(reinterpret_cast<const float*>(tile), part, melw, chunks, first, n_chunks, n_mels,
           out + (static_cast<long long>(b) * F + f0 + fl) * n_mels, amin, log_ref, lane);
  }
}

template <int N>
int launch(const float* wave, const float* win, const float2* tw, const float2* stw,
           const float* melw, const int* chunks, const int* first, float* out, int B, int T,
           int F, int hop, int n_mels, int n_chunks, int run, int warps, int vec,
           int smem, float amin, float log_ref, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((F + run - 1) / run, B);
  kernel<N><<<grid, warps * 32, smem, stream>>>(wave, win, tw, stw, melw, chunks, first, out,
                                                T, F, hop, n_mels, n_chunks, run, vec,
                                                amin, log_ref);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace frames

}  // namespace

// The frame-run kernel for n_fft in 256, 512, 1024, 2048, `run` frames a
// block and `warps` warps. Returns the
// launch's cudaGetLastError() as an int (0 = success), or
// cudaErrorInvalidValue for what it does not take: another n_fft, warps
// outside 1..8, `smem` other than the layout's total or over the card's
// limit, vec = 4 where the row, the hop, the padding or the wave's address
// are not multiples of 16 bytes.
extern "C" int log_mel_frames(const void* wave, const void* win, const void* tw,
                              const void* split_tw, const void* melw, const void* chunks,
                              const void* first, void* out, int B, int T, int F, int n_fft,
                              int hop, int n_mels, int n_chunks, int run,
                              int warps, int vec, int smem, float amin, float log_ref,
                              void* stream) {
  const frames::Layout lay(n_fft, n_mels, n_chunks, warps, run, hop);
  const bool aligned = T % 4 == 0 && hop % 4 == 0 && (n_fft / 2) % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(wave) % 16 == 0;
  if (warps < 1 || warps > frames::kMaxWarps || run < 1 || hop < 1 || B < 1 ||
      lay.total != smem || smem > frames::kSmemLimit || (vec != 1 && vec != 4) ||
      (vec == 4 && !aligned) || T <= n_fft / 2 || F != T / hop + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define K2_ARGS                                                                              \
  static_cast<const float*>(wave), static_cast<const float*>(win),                          \
      static_cast<const float2*>(tw), static_cast<const float2*>(split_tw),                 \
      static_cast<const float*>(melw), static_cast<const int*>(chunks),                     \
      static_cast<const int*>(first), static_cast<float*>(out), B, T, F, hop, n_mels,       \
      n_chunks, run, warps, vec, smem, amin, log_ref, static_cast<cudaStream_t>(stream)
  switch (n_fft) {
    case 256: return frames::launch<256>(K2_ARGS);
    case 512: return frames::launch<512>(K2_ARGS);
    case 1024: return frames::launch<1024>(K2_ARGS);
    case 2048: return frames::launch<2048>(K2_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K2_ARGS
}

// The first kernel, one block per (frame, batch row). Returns the launch's
// cudaGetLastError() as an int (0 = success). n_fft is a power of two (the
// wrapper also bounds it to 4096: 32 KB of shared memory).
extern "C" int log_mel_radix2(const void* wave, const void* win, const void* tw,
                              const void* mel_w, const void* mel_lo, const void* mel_hi,
                              void* out, int B, int T, int F, int n_fft, int hop,
                              int n_mels, float amin, float log_ref, void* stream) {
  int log2n = 0;
  while ((1 << log2n) < n_fft) ++log2n;
  if ((1 << log2n) != n_fft || n_fft < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(F, B);
  const size_t smem = sizeof(float2) * n_fft;
  radix2::kernel<<<grid, radix2::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wave), static_cast<const float*>(win),
      static_cast<const float2*>(tw), static_cast<const float*>(mel_w),
      static_cast<const int*>(mel_lo), static_cast<const int*>(mel_hi),
      static_cast<float*>(out), T, F, n_fft, log2n, hop, n_mels, amin, log_ref);
  return static_cast<int>(cudaGetLastError());
}
