#!/usr/bin/env python3
"""Quick loop for work on K1 (``zs_aac_tpu_torch/csrc/decode_attn.cu``) on a
CUDA card, and a way to time two checkouts' K1 the same way.

Run from the repository root: ``python3 examples/probe_decode_attn.py
[--root DIR]``. ``--root`` imports ``zs_aac_tpu_torch`` from another checkout
(an unpacked ``git archive`` of the parent commit, say), so two trees are
checked and timed by one script; the helpers come from this checkout's
``chip_smoke.py``.

It holds K1 against its plain version at the decode's shapes (B = 256, 12
heads, d = 64, T = 77, bf16; index 10, 40 and 76, the cache rows and scales
bytewise equal). It then runs the decode's order on one cache (indices
10..76 in turn, new q/k/v each step, d = 64 and 24, inputs from a fixed seed
so two checkouts see the same ones) and counts the output elements that
differ from the plain version's, the largest difference in bf16 steps at the
largest |o| (``chip_smoke.py::K1_TOL``), and the steps over the fixed 3e-2
that limit replaced: a change of summation order moves an element by one
step where the two fp32 sums straddle a rounding boundary. Last, it
times K1 at every index 10..76, each call reading its rows from device
memory (4 input sets of 30 MB rotate, more than the 50 MB L2): launched from
Python, as the decode launches it, and as a CUDA graph of the same 20
launches (the kernel's own time), beside the byte bound, and prints the
host's time to enqueue one call. About 20 s.

Exit code 1 if a case disagrees.
"""

import importlib.util
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    args = sys.argv[1:]
    root = HERE
    if args[:1] == ["--root"] and len(args) == 2:
        root = os.path.abspath(args[1])
    elif args:
        sys.exit(__doc__)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from zs_aac_tpu_torch.ops.decode_attn import decode_attn_q8, decode_attn_q8_plain

    print(f"package from {root}; {torch.cuda.get_device_name(0)}", flush=True)
    B, H, T, d = 256, 12, 77, 64
    g = torch.Generator(device="cuda").manual_seed(3)
    ok = True
    for index in (10, 40, 76):
        a = cs.k1_inputs(B, H, T, d, torch.bfloat16, g)
        b = [x.clone() for x in a[3:]]
        o, o_ref = decode_attn_q8(*a, index), decode_attn_q8_plain(*a[:3], *b, index)
        err = (o.float() - o_ref.float()).abs().max().item()
        tol = cs.k1_tol("bfloat16", o_ref)
        same = all(torch.equal(x, y) for x, y in zip(a[3:], b))
        print(f"index {index}: max|o-o_plain| {err:.3g} (tol {tol:.3g}), cache bytes equal "
              f"{same}", flush=True)
        ok &= err <= tol and same

    for dd in (64, 24):
        gs = torch.Generator(device="cuda").manual_seed(5)
        a = cs.k1_inputs(B, H, T, dd, torch.bfloat16, gs)
        b = [x.clone() for x in a[3:]]
        n_diff, n_elems, max_steps, n_old, n_new = 0, 0, 0.0, 0, 0
        for index in range(10, T):
            qkv = [torch.randn(B, H, dd, generator=gs, device="cuda").bfloat16() * s
                   for s in (1, 2, 1)]
            o = decode_attn_q8(*qkv, *a[3:], index).float()
            o_ref = decode_attn_q8_plain(*qkv, *b, index).float()
            diff = (o - o_ref).abs()
            n_diff += int((diff > 0).sum())
            n_elems += diff.numel()
            err, tol = diff.max().item(), cs.k1_tol("bfloat16", o_ref)
            max_steps = max(max_steps, err / tol)     # tol: one bf16 step at the largest |o|
            n_old += err > 3e-2                       # the limit before K1_TOL's bf16 rule
            n_new += err > tol
            ok &= all(torch.equal(x, y) for x, y in zip(a[3:], b))
        print(f"d={dd}, indices 10..76 in turn on one cache (seed 5): {n_diff} of {n_elems} "
              f"output elements differ from the plain version's ({n_diff / n_elems:.4%}), "
              f"the largest by {max_steps:g} bf16 steps at the step's largest |o|; steps over "
              f"3e-2: {n_old} of {T - 10}, over K1_TOL: {n_new}", flush=True)
        ok &= n_new == 0

    bufs = [cs.k1_inputs(B, H, T, d, torch.bfloat16, g) for _ in range(4)]
    eager, graph, bound = [], [], []
    for index in range(10, T):
        decode_attn_q8(*bufs[0], index)
        eager.append(cs.timed_ms(lambda r: decode_attn_q8(*bufs[r % 4], index), 20) * 1e3)
        graph.append(cs.graph_ms(lambda r: decode_attn_q8(*bufs[r % 4], index), 20) * 1e3)
        bound.append(cs.k1_bound(B, H, d, index, 2)[0] * 1e3)
    print(f"K1 per call, mean over index 10..76 (B={B} bf16, L2-cold): "
          f"{statistics.mean(graph):.2f} us in a CUDA graph, {statistics.mean(eager):.2f} us "
          f"launched from Python; bound {statistics.mean(bound):.2f} us "
          f"({statistics.mean(bound) / statistics.mean(graph):.1%} of it in the graph); "
          f"index 10 / 40 / 76: graph {graph[0]:.2f} / {graph[30]:.2f} / {graph[66]:.2f}, "
          f"Python {eager[0]:.2f} / {eager[30]:.2f} / {eager[66]:.2f}, "
          f"bound {bound[0]:.2f} / {bound[30]:.2f} / {bound[66]:.2f} us", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(400):
        decode_attn_q8(*bufs[r % 4], 40)
    host = (time.perf_counter() - t0) / 400 * 1e6
    torch.cuda.synchronize()
    print(f"host time to enqueue one call: {host:.1f} us", flush=True)
    print("all cases agree" if ok else "SOME CASES DISAGREE")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
