#!/usr/bin/env python3
"""Quick loop for work on ``zs_aac_tpu_torch/csrc/window_attn.cu`` on a CUDA card.

Run from the repository root: ``python3 examples/probe_window_kernels.py
[nvcc flag ...]`` (for example ``-DSOME_SWITCH`` while trying a variant). It
builds the source (into a temporary directory when flags are given, and shows
ptxas' registers, spills and warnings), holds K3, K5 and K7 in bf16 against
their plain versions at HTSAT's four stage shapes (B = 2, 3 and 64, shift 0
and 4, keep scales holding zeros) with ``chip_smoke.py``'s tolerances, and
times K3 and K5 per stage at B = 64 with CUDA events (``chip_smoke.timed_ms``).
About 40 s; exit code 1 if a case disagrees.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import chip_smoke as cs
from zs_aac_tpu_torch.ops import window_attn as wa
from zs_aac_tpu_torch.utils import cuda_build

STAGES = cs.STAGES + [(8, 768, 32)]


def build(flags):
    """Load the library, built with extra nvcc ``flags`` if any; print the
    compiler's report without its per-function headers."""
    if flags:
        so = os.path.join(tempfile.mkdtemp(), "libwindow_attn.so")
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o", so,
               str(cuda_build.CSRC / "window_attn.cu")]
        done = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if done.returncode:
            sys.exit(done.stdout)
        cuda_build._LIBS["window_attn"] = ctypes.CDLL(so)
        report = done.stdout
    else:
        report = "".join(out for _, out in cuda_build.build(["window_attn"]).values())
    for line in report.splitlines():
        if "Function properties" not in line:
            print(line[:200])


def check(B, H, C, heads, shift, g):
    x, w, bias = cs._window_case(B, H, C, heads, 8, torch.bfloat16, g)
    m1 = torch.tensor([1 / 0.9, 0.0, 1.0], device="cuda").repeat(B)[:B].contiguous()
    m2 = m1.flip(0).contiguous()
    cfg = (8, heads, shift, 1e-6)
    res = {}
    ref = wa.swin_block_plain(x, *w, bias, *cfg)
    res["K3"] = (wa.fused_swin_block(x, *w, bias, *cfg), ref, cs.window_tol("bfloat16", ref))
    ref = wa.window_attention_plain(x, *w[2:6], bias, *cfg[:3])
    res["K5"] = (wa.fused_window_attention(x, *w[2:6], bias, *cfg[:3]), ref,
                 cs.window_tol("bfloat16", ref))
    ref, y_ref = wa.swin_block_train_plain(x, *w, bias, m1, m2, *cfg)
    out, y = wa._launch(wa.fused_swin_block_train, True, x, *w[2:6], bias, *cfg[:3],
                        ln=(w[0], w[1], w[6], w[7]), mlp_w=tuple(w[8:]), eps=1e-6, keep=(m1, m2))
    ref32 = wa.swin_block_train_plain(*cs._f32([x] + w), bias, m1, m2, *cfg)[0]
    res["K7"] = (out, ref, cs.train_tol(ref, ref32))
    res["K7.y"] = (y, y_ref, cs.window_tol("bfloat16", y_ref))
    torch.cuda.synchronize()
    errs = {k: ((got.float() - want.float()).abs().max().item(), tol)
            for k, (got, want, tol) in res.items()}
    bad = [k for k, (e, tol) in errs.items() if not e <= tol]
    print(f"B={B} {H}x{H}x{C} shift={shift}: "
          + ", ".join(f"{k} {e:.3g}/{tol:.3g}" for k, (e, tol) in errs.items())
          + (f"  DISAGREES: {bad}" if bad else ""), flush=True)
    return not bad


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_window_kernels: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    build(sys.argv[1:])
    g = torch.Generator(device="cuda").manual_seed(5)
    ok = all([check(B, H, C, heads, shift, g)
              for B in (2, 3, 64) for H, C, heads in STAGES for shift in (0, 4)])
    for H, C, heads in STAGES:
        x, w, bias = cs._window_case(64, H, C, heads, 8, torch.bfloat16, g)
        k3 = lambda r: wa.fused_swin_block(x, *w, bias, 8, heads, 0, 1e-6)
        k5 = lambda r: wa.fused_window_attention(x, *w[2:6], bias, 8, heads, 0)
        k3(0), k5(0)
        print(f"[time] B=64 {H}x{H}x{C}: K3 {cs.timed_ms(k3, 10) * 1e3:.1f} us, "
              f"K5 {cs.timed_ms(k5, 10) * 1e3:.1f} us", flush=True)
    print("all cases agree" if ok else "SOME CASES DISAGREE")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
