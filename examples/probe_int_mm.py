#!/usr/bin/env python3
"""Time ``torch._int_mm`` at the Mistral-7B decode's GEMM shapes on a card,
with the int8 weight row-major and column-major, beside the bf16 product.

Run on a CUDA card from the repository root: ``python3 examples/probe_int_mm.py``
(~15 s). For M rows of activations (32, 64, 256) and the weights [K, N] of
the fused q/k/v, o, fused gate/up, down and lm_head projections, it prints
the mean µs of a call by CUDA events (50 calls after one warm-up), whether
the two layouts give equal int32 results, and the int8 weight's byte bound
at 3.35 TB/s.
"""

import torch


def timed_us(fn, reps=50):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    for M in (32, 64, 256):
        for K, N in ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 32000)):
            a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device="cuda")
            w = torch.randint(-127, 128, (K, N), dtype=torch.int8, device="cuda")
            wt = w.t().contiguous()                  # w's values, column-major as wt.t()
            same = torch.equal(torch._int_mm(a, w), torch._int_mm(a, wt.t()))
            ab, wb = a.to(torch.bfloat16), w.to(torch.bfloat16)
            print(f"M={M} K={K} N={N}: row-major b {timed_us(lambda: torch._int_mm(a, w)):.1f} us, "
                  f"col-major b {timed_us(lambda: torch._int_mm(a, wt.t())):.1f} us, "
                  f"equal {same}; bf16 {timed_us(lambda: ab @ wb):.1f} us; int8 bytes bound "
                  f"{K * N / 3.35e12 * 1e6:.1f} us", flush=True)


if __name__ == "__main__":
    main()
