#!/usr/bin/env python3
"""Quick loop for work on K1g (``zs_aac_tpu_torch/csrc/decode_attn_gqa.cu``)
on a CUDA card, and a way to time two checkouts' K1g the same way.

Run from the repository root: ``python3 examples/probe_decode_attn_gqa.py
[--root DIR]``. ``--root`` imports ``zs_aac_tpu_torch`` from another checkout
(a scratch copy with other constants, say), so two trees are checked and
timed by one script; the helpers come from this checkout's ``chip_smoke.py``.

At the Mistral-7B cell's shapes (B = 2,048, 8 kv heads of 4 query heads, d =
128, bf16) it holds K1g against its plain version at the decode's first and
last index (13 and 71: the committed rows bitwise, o within one bf16 step at
the largest |o|), then times it at every index 13..71 over two input sets
(each a 153 MB cache, three times the L2): in a CUDA graph of 20 launches
(the kernel's own time) and launched from Python, beside the byte bound, and
the host's time to enqueue one call. Last, the time of a call against the
batch (B = 16 .. 2,048 at indices 13 and 71): where a few waves of warps
take as long as one, a (b, kv head)'s latency and not the bytes set the
time. If it builds the kernel, it prints ptxas's register and spill counts.
About 40 s after the build.

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
    sys.path.append(HERE)     # benchmark/costs, for the bound
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from zs_aac_tpu_torch.utils.cuda_build import build

    for name, (secs, out) in build(["decode_attn_gqa"]).items():
        lines = [ln.split(":", 1)[-1].strip() for ln in out.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"built {name} in {secs:.1f} s; ptxas: {' | '.join(lines)}", flush=True)
    from zs_aac_tpu_torch.ops.decode_attn_gqa import (decode_attn_gqa_plan, decode_attn_gqa_q8,
                                                      decode_attn_gqa_q8_plain)

    print(f"package from {root}; {torch.cuda.get_device_name(0)}", flush=True)
    c = cs.K1G_CELL
    B, KV, rep, d = c["B"], c["KV"], c["rep"], c["d"]
    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(3)
    ok = True
    with torch.no_grad():
        for index in c["indices"]:
            a = cs.k1g_inputs(B, KV, rep, d, 73, index, bf, g)
            b = [x.clone() for x in a[4:]]
            o = decode_attn_gqa_q8(*a, index, 0)
            ref = decode_attn_gqa_q8_plain(*a[:4], *b, index, 0)
            err = (o.float() - ref.float()).abs().max().item()
            tol = cs.k1_tol("bfloat16", ref)
            same = all(torch.equal(x, y) for x, y in zip(a[4:], b))
            ok &= err <= tol and same
            print(f"index {index}: plan {decode_attn_gqa_plan(bf, d, rep, index + 1)}, "
                  f"max|o-o_plain| {err:.3g} (tol {tol:.3g}), cache equal {same}", flush=True)
            del a, b
        bufs = [cs.k1g_inputs(B, KV, rep, d, 73, 13, bf, g) for _ in range(2)]
        gms, kms, bms = [], [], []
        for index in range(13, 72):
            call = lambda r: decode_attn_gqa_q8(*bufs[r % 2], index, 0)
            call(0)
            gms.append(cs.graph_ms(call, 20))
            kms.append(cs.timed_ms(call, 20))
            bms.append(cs.k1g_bound(B, KV * rep, KV, d, index, 0, 2)[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in range(200):
            decode_attn_gqa_q8(*bufs[r % 2], 40, 0)
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        del bufs
        sweep = []
        for index in c["indices"]:
            for b in (16, 128, 512, 2048):
                bb = [cs.k1g_inputs(b, KV, rep, d, 73, index, bf, g) for _ in range(2)]
                call = lambda r: decode_attn_gqa_q8(*bb[r % 2], index, 0)
                call(0)
                sweep.append(f"i{index} B={b}: {cs.graph_ms(call, 20) * 1e3:.2f}")
                del bb
    gm, km, bm = (statistics.mean(v) * 1e3 for v in (gms, kms, bms))
    print(f"K1g at B={B}, mean over index 13..71: {gm:.2f} us in a CUDA graph ({bm / gm:.1%} of "
          f"the {bm:.2f} us bound), {km:.2f} us launched from Python ({bm / km:.1%}); index "
          f"13 / 71: {gms[0] * 1e3:.2f} / {gms[-1] * 1e3:.2f} us in the graph (bound "
          f"{bms[0] * 1e3:.2f} / {bms[-1] * 1e3:.2f}); a step's 32 layers "
          f"{32 * gm / 1e3:.3f} ms; host {host_us:.1f} us to enqueue a call", flush=True)
    print(f"K1g in a CUDA graph against the batch (us): {'; '.join(sweep)}", flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
