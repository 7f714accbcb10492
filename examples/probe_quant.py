#!/usr/bin/env python3
"""Time the w8a8 GEMM's quantize and rescale kernels (``csrc/quant.cu``) on
a card at the caption cells' shapes, beside the plain ATen chains and the
byte bound.

Run on a CUDA card from the repository root: ``python3 examples/probe_quant.py``
(~30 s with the build). For each shape it prints the mean µs of a kernel
call by CUDA events over 20 calls replayed in a CUDA graph (the kernel's own
time; inputs rotated over enough copies to pass the 50 MB L2, so each call
reads from device memory), the mean of 50 calls launched from Python (host
cost included), the plain version's (``quant_act_plain``,
``int8_rescale_plain``) launched from Python, whether the two are bitwise
equal, and the byte bound at 3.35 TB/s: quantize M K (sizeof(x) + 1) + 4 M
bytes, rescale M N (4 + sizeof(out)) + 4 M + 4 N (+ the bias) bytes. The
first line names the card and its power limit; ``--json PATH`` also writes
the rows there.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from zs_aac_tpu_torch.ops import quant as Q  # noqa: E402

HBM = 3.35e12
L2 = 50 * 2 ** 20

# (cell, M, K, dtype): every quantize of a decode step; the prefill's rows
QUANT = [("gpt2", 8192, 768, torch.float32), ("gpt2", 8192, 3072, torch.float32),
         ("gpt2.prefill", 81920, 768, torch.float32),
         ("mistral7b", 2048, 4096, torch.bfloat16), ("mistral7b", 2048, 14336, torch.bfloat16)]
# (cell, M, N, out dtype, bias): every rescale of a decode step
RESCALE = [("gpt2", 8192, 2304, torch.float32, True), ("gpt2", 8192, 768, torch.float32, True),
           ("gpt2", 8192, 3072, torch.float32, True), ("gpt2", 8192, 50264, torch.float32, False),
           ("mistral7b", 2048, 4096, torch.bfloat16, False),
           ("mistral7b", 2048, 1024, torch.bfloat16, False),
           ("mistral7b", 2048, 14336, torch.bfloat16, False),
           ("mistral7b", 2048, 32000, torch.bfloat16, False)]


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0) + ", power limit unread"


def timed_us(fn, inputs, reps=50):
    fn(*inputs[0])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def graph_us(fn, inputs, reps=20):
    """The same calls captured in one CUDA graph and replayed: the kernels'
    own time, without the host's launch cost."""
    fn(*inputs[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def copies(nbytes: int) -> int:
    return max(1, -(-2 * L2 // nbytes))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_quant: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card()}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    with torch.no_grad():
        for cell, M, K, dt in QUANT:
            n = copies(M * K * dt.itemsize)
            xs = [((torch.randn(M, K, generator=g, device="cuda") * 3).to(dt),) for _ in range(n)]
            equal = all(torch.equal(a, b) for a, b in zip(Q.quant_act(*xs[0]),
                                                           Q.quant_act_plain(*xs[0])))
            bound = (M * K * (dt.itemsize + 1) + 4 * M) / HBM * 1e6
            rows.append({"kernel": "quant_act", "cell": cell, "M": M, "K": K,
                         "dtype": str(dt).split(".")[1], "kernel_us": graph_us(Q.quant_act, xs),
                         "launched_us": timed_us(Q.quant_act, xs),
                         "plain_us": timed_us(Q.quant_act_plain, xs), "bound_us": bound,
                         "bitwise": equal})
            del xs
        for cell, M, N, dt, bias in RESCALE:
            n = copies(M * N * 4)
            ys = []
            for _ in range(n):
                y = torch.randint(-2 ** 27, 2 ** 27, (M, N), generator=g, device="cuda",
                                  dtype=torch.int32)
                ys.append((y, torch.rand(M, 1, generator=g, device="cuda") * 0.05 + 1e-4,
                           torch.rand(N, generator=g, device="cuda") * 0.01, dt,
                           torch.randn(N, generator=g, device="cuda").to(dt) if bias else None))
            equal = torch.equal(Q.int8_rescale(*ys[0]), Q.int8_rescale_plain(*ys[0]))
            nbytes = M * N * (4 + dt.itemsize) + 4 * M + 4 * N + (N * dt.itemsize if bias else 0)
            rows.append({"kernel": "int8_rescale", "cell": cell, "M": M, "N": N,
                         "dtype": str(dt).split(".")[1], "bias": bias,
                         "kernel_us": graph_us(Q.int8_rescale, ys),
                         "launched_us": timed_us(Q.int8_rescale, ys),
                         "plain_us": timed_us(Q.int8_rescale_plain, ys),
                         "bound_us": nbytes / HBM * 1e6, "bitwise": equal})
            del ys
    for r in rows:
        shape = f"M={r['M']} " + (f"K={r['K']}" if "K" in r else f"N={r['N']} bias={r['bias']}")
        print(f"{r['kernel']} {r['cell']} {shape} {r['dtype']}: kernel {r['kernel_us']:.2f} us "
              f"({100 * r['bound_us'] / r['kernel_us']:.1f}% of bound {r['bound_us']:.2f} us), "
              f"launched from Python {r['launched_us']:.2f} us, plain {r['plain_us']:.2f} us, "
              f"bitwise {r['bitwise']}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card(), "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
