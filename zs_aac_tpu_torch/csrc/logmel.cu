// Kernel K2: the log-mel frontend, wave [B, T] fp32 -> [B, 1, F, n_mels] fp32.
//
// Replaces the Pallas TPU kernel zs_aac_tpu/ops/logmel.py::_logmel_kernel and
// computes the function of log_mel_xla (the port's log_mel_plain): reflect
// padding by n_fft/2 (the reflected index is computed here, so no padded copy
// of the wave exists), frames every `hop` samples, a periodic Hann window, the
// power spectrum |rfft|^2, a Slaney mel filterbank and
// 10*log10(max(mel, amin)) - 10*log10(max(amin, ref)).
//
// Bound: bytes. A call must read the wave once and write the log-mel once
// (B=64, T=320000: 82 MB in, 16 MB out); the FFT costs ~5 n log2 n flops per
// frame, some 20 flops per byte moved, far below the card's ridge point. The
// TPU kernel's DFT-as-two-matmuls against window-folded bases fed the MXU;
// here it would cost 2 n^2 flops a frame, 100x an FFT, so each frame's
// spectrum is a radix-2 FFT in shared memory instead: one thread block per
// (frame, batch row) loads its n_fft samples (neighbouring frames share 69% of
// them, which L2 serves), runs log2(n_fft) butterfly stages, and sums each
// mel over its band of non-zero filterbank bins only. One block moves 4 KB in
// and 256 B out, so many blocks are in flight on every SM to hide latency.
//
// Numerics: fp32 throughout, twiddles computed in float64 on the host. The
// spectrum differs from torch.fft.rfft by summation order (~1e-6 relative),
// which moves the log-mel by well under 0.01 dB wherever the mel power is
// above the fp32 FFT's rounding floor (~1e-12 of the frame's peak power).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no fast-math: log10f and the FFT stay IEEE).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
log_mel_kernel(const float* __restrict__ wave, const float* __restrict__ win,
               const float2* __restrict__ tw, const float* __restrict__ mel_w,
               const int* __restrict__ mel_lo, const int* __restrict__ mel_hi,
               float* __restrict__ out, int T, int F, int n_fft, int log2n,
               int hop, int n_mels, float amin, float log_ref) {
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

}  // namespace

// Returns the launch's cudaGetLastError() as an int (0 = success). n_fft is a
// power of two (the wrapper also bounds it to 4096: 32 KB of shared memory).
extern "C" int log_mel(const void* wave, const void* win, const void* tw,
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
  log_mel_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wave), static_cast<const float*>(win),
      static_cast<const float2*>(tw), static_cast<const float*>(mel_w),
      static_cast<const int*>(mel_lo), static_cast<const int*>(mel_hi),
      static_cast<float*>(out), T, F, n_fft, log2n, hop, n_mels, amin, log_ref);
  return static_cast<int>(cudaGetLastError());
}
