#!/usr/bin/env python3
"""Quick loop for work on the Swin kernels (``zs_aac_tpu_torch/csrc/
window_attn.cu`` and ``swin_train.cu``) on a CUDA card.

Run from the repository root: ``python3 examples/probe_window_kernels.py
[--train [--fma]] [nvcc flag ...]`` (for example ``-DSOME_SWITCH`` while
trying a variant). It builds the source (into a temporary directory when
flags are given, and shows ptxas' registers, spills and warnings).

Without ``--train`` it holds K3, K5 and K7 in bf16 against their plain
versions at HTSAT's four stage shapes (B = 2, 3 and 64, shift 0 and 4, keep
scales holding zeros) with ``chip_smoke.py``'s tolerances, and times K3 and
K5 per stage at B = 64 with CUDA events (``chip_smoke.timed_ms``). About 40 s.

With ``--train`` it builds ``swin_train.cu`` instead, holds K8 and K9 (B = 3
and 64, stages 1-3, bf16 and fp32; K9 at shift 0 and 4, bitwise equal run to
run), K6 in bf16 at C = 768 (B = 3 and 64, 8x8 and 16x16, shift 0 and 4,
bitwise equal run to run) and the split-token weight-gradient product (the
shapes of K6, K8 and K9, a ragged token count) against their plain versions,
and times, per stage at B = 64 in bf16, the parts of K8 (the per-token
kernel, each weight product, the reductions), of K9 (stages 1-3) and of K6
(stage 4): the per-window kernel, the dx kernel, each weight product, the
bias column sums or their reduction, the dbias reduction; then K8, K9 and K6
whole beside their plain versions. ``--fma`` sends bf16 through the FMA
kernels, whatever ``mlp_bwd_plan``, ``attn_bwd_plan`` and ``wgrad_plan`` say,
to time them beside the tensor-core ones. About 90 s.

Exit code 1 if a case disagrees.
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


def build(name, flags):
    """Load the library ``name``, built with extra nvcc ``flags`` if any; print
    the compiler's report without its per-function headers."""
    if flags:
        so = os.path.join(tempfile.mkdtemp(), f"lib{name}.so")
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o", so,
               str(cuda_build.CSRC / f"{name}.cu")]
        done = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if done.returncode:
            sys.exit(done.stdout)
        cuda_build._LIBS[name] = ctypes.CDLL(so)
        report = done.stdout
    else:
        report = "".join(out for _, out in cuda_build.build([name]).values())
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


def check_k8(B, H, C, heads, dtype, g):
    y, w, _ = cs._window_case(B, H, C, heads, 8, dtype, g)
    gout = torch.randn(B, H, H, C, generator=g, device="cuda").to(dtype)
    m2 = torch.tensor([1 / 0.9, 0.0, 1.0], device="cuda").repeat(B)[:B].contiguous()
    ln2_fc = w[6:11]
    got = wa.mlp_bwd(y, gout, m2, *ln2_fc, 1e-6)
    want = wa.mlp_bwd_plain(y, gout, m2, *ln2_fc, 1e-6)
    refs = [None] * 7
    if dtype == torch.bfloat16:
        refs = wa.mlp_bwd_plain(*cs._f32([y, gout]), m2, *cs._f32(ln2_fc), 1e-6)
    torch.cuda.synchronize()
    names = ["dy", "dln2_s", "dln2_b", "dfc1_w", "dfc1_b", "dfc2_w", "dfc2_b"]
    errs = {n: ((a.float() - b.float()).abs().max().item(), cs.train_tol(b, r))
            for n, a, b, r in zip(names, got, want, refs)}
    bad = [n for n, (e, tol) in errs.items() if not e <= tol]
    print(f"K8 {str(dtype)[6:]} B={B} {H}x{H}x{C}: "
          + ", ".join(f"{n} {e:.3g}/{tol:.3g}" for n, (e, tol) in errs.items())
          + (f"  DISAGREES: {bad}" if bad else ""), flush=True)
    return not bad


def check_k9(B, H, C, heads, shift, dtype, g):
    x, w, bias = cs._window_case(B, H, C, heads, 8, dtype, g)
    gout = torch.randn(B, H, H, C, generator=g, device="cuda").to(dtype)
    m1 = torch.tensor([1 / 0.9, 0.0, 1.0], device="cuda").repeat(B)[:B].contiguous()
    cfg = (8, heads, shift, 1e-6)
    got = wa.attn_ln1_bwd(x, gout, m1, *w[:5], bias, *cfg)
    again = wa.attn_ln1_bwd(x, gout, m1, *w[:5], bias, *cfg)
    want = wa.attn_ln1_bwd_plain(x, gout, m1, *w[:5], bias, *cfg)
    refs = [None] * 8
    if dtype == torch.bfloat16:
        refs = wa.attn_ln1_bwd_plain(*cs._f32([x, gout]), m1, *cs._f32(w[:5]), bias, *cfg)
    torch.cuda.synchronize()
    names = ["dx", "dln1_s", "dln1_b", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b", "dbias"]
    errs = {n: ((a.float() - b.float()).abs().max().item(), cs.train_tol(b, r))
            for n, a, b, r in zip(names, got, want, refs)}
    bad = [n for n, (e, tol) in errs.items() if not e <= tol]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    dropped = torch.equal(got[0][1], gout[1]) if B > 1 else True
    print(f"K9 {str(dtype)[6:]} B={B} {H}x{H}x{C} shift={shift}: "
          + ", ".join(f"{n} {e:.3g}/{tol:.3g}" for n, (e, tol) in errs.items())
          + ("" if same else "  RUN TO RUN DIFFERS") + ("" if dropped else "  DROPPED ROW MOVED")
          + (f"  DISAGREES: {bad}" if bad else ""), flush=True)
    return not bad and same and dropped


def check_k6(B, H, shift, dtype, g):
    """K6 at C = 768 (stage 4 when H = 8), bitwise equal run to run."""
    x, w, bias = cs._window_case(B, H, 768, 32, 8, dtype, g)
    gout = torch.randn(B, H, H, 768, generator=g, device="cuda").to(dtype)
    cfg = (8, 32, shift)
    got = wa.window_attention_bwd(x, gout, *w[2:6], bias, *cfg)
    again = wa.window_attention_bwd(x, gout, *w[2:6], bias, *cfg)
    want = wa.window_attention_bwd_plain(x, gout, *w[2:6], bias, *cfg)
    refs = wa.window_attention_bwd_plain(*cs._f32([x, gout] + w[2:6]), bias, *cfg)
    torch.cuda.synchronize()
    names = ["dx", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b", "dbias"]
    errs = {n: ((a.float() - b.float()).abs().max().item(), cs.train_tol(b, r))
            for n, a, b, r in zip(names, got, want, refs)}
    bad = [n for n, (e, tol) in errs.items() if not e <= tol]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"K6 {str(dtype)[6:]} B={B} {H}x{H}x768 shift={shift}: "
          + ", ".join(f"{n} {e:.3g}/{tol:.3g}" for n, (e, tol) in errs.items())
          + ("" if same else "  RUN TO RUN DIFFERS") + (f"  DISAGREES: {bad}" if bad else ""),
          flush=True)
    return not bad and same


def check_wgrad(n_tok, M, Ncol, g):
    A = torch.randn(n_tok, M, generator=g, device="cuda").bfloat16()
    B = torch.randn(n_tok, Ncol, generator=g, device="cuda").bfloat16()
    got, tc = wa._wgrad(wa._train_lib(), "probe", A, M, B, Ncol, n_tok, M, Ncol)
    want = A.float().t() @ B.float()
    err, tol = (got - want).abs().max().item(), 1e-4 * want.abs().max().item()
    again = wa._wgrad(wa._train_lib(), "probe", A, M, B, Ncol, n_tok, M, Ncol)[0]
    ok = err <= tol and torch.equal(got, again)
    print(f"wgrad [{n_tok}, {M}]^T [{n_tok}, {Ncol}] ({'tc' if tc else 'fma'}): {err:.3g}/"
          f"{tol:.3g}, run to run {'bitwise equal' if torch.equal(got, again) else 'DIFFERS'}"
          + ("" if ok else "  DISAGREES"), flush=True)
    return ok


def time_train(H, C, heads, g):
    """The parts of K8 and of K9 at B = 64 in bf16, then K8, K9 and their
    plain versions (K6 at stage 4) per call."""
    us = lambda fn, reps=5: (fn(0), cs.timed_ms(fn, reps) * 1e3)[1]
    x, w, bias, gout, m1, m2 = cs._train_case(64, H, C, heads, torch.bfloat16, g)
    cfg = (8, heads, 4, 1e-6)
    line = f"[time] B=64 {H}x{H}x{C}:"
    lib, n_tok, hidden = wa._train_lib(), 64 * H * H, 4 * C
    if C == 768:
        plan6 = wa.attn_bwd_plan(torch.bfloat16, 64, C, C // heads, False)
        args6 = ("probe", lib, plan6, x, gout, None, None, *w[2:5], bias, *cfg)
        scratch = wa._attn_bwd_tokens(*args6)
        _, xn_s, go_s, o_s, dqkv_s, dbias_part, ln_part = scratch
        parts6 = {
            "per-window": us(lambda r: wa._attn_bwd_tokens(*args6, parts=1, scratch=scratch)),
            "dx": us(lambda r: wa._attn_bwd_tokens(*args6, parts=2, scratch=scratch)),
            "dWqkv": us(lambda r: wa._wgrad(lib, "probe", xn_s, C, dqkv_s, 3 * C, n_tok, C,
                                            3 * C)),
            "dWproj": us(lambda r: wa._wgrad(lib, "probe", o_s, C, go_s, C, n_tok, C, C)),
            # the tensor-core dx kernel sums go and dqkv itself
            "dbqkv + dbproj": us(lambda r: (
                wa._wgrad(lib, "probe", None, 0, dqkv_s, 3 * C, n_tok, 1, 3 * C),
                wa._wgrad(lib, "probe", None, 0, go_s, C, n_tok, 1, C)))
            if plan6[0] == "fma" else us(lambda r: wa._reduce(lib, "probe", ln_part)),
            "reduce dbias": us(lambda r: wa._reduce(lib, "probe", dbias_part)),
        }
        k6 = us(lambda r: wa.window_attention_bwd(x, gout, *w[2:6], bias, *cfg[:3]))
        p6 = us(lambda r: wa.window_attention_bwd_plain(x, gout, *w[2:6], bias, *cfg[:3]))
        print(f"{line} K6 ({plan6[0]}) parts (" + ", ".join(f"{k} {v:.1f}" for k, v in
                                                         parts6.items())
              + f") sum {sum(parts6.values()):.1f} us; K6 {k6:.1f} us, plain {p6:.1f} us",
              flush=True)
        return
    ln2_fc = w[6:11]
    plan = wa.mlp_bwd_plan(torch.bfloat16, n_tok, C, hidden)
    tokens = lambda r: wa._mlp_bwd_tokens("probe", lib, plan, x, gout, m2, *ln2_fc, 1e-6)
    _, yn_s, gz_s, hg_s, dh1_s, ln_part, fc1b_part = tokens(0)
    parts = {
        "per-token": us(tokens),
        "dWfc1": us(lambda r: wa._wgrad(lib, "probe", yn_s, C, dh1_s, hidden, n_tok, C, hidden)),
        "dWfc2": us(lambda r: wa._wgrad(lib, "probe", hg_s, hidden, gz_s, C, n_tok, hidden, C)),
        "dbfc2 (FMA route only)": us(lambda r: wa._wgrad(lib, "probe", None, 0, gz_s, C, n_tok,
                                                         1, C)) if plan[0] == "fma" else 0.0,
        "reduce dLN2": us(lambda r: wa._reduce(lib, "probe", ln_part)),
        "reduce dbfc1": us(lambda r: wa._reduce(lib, "probe", fc1b_part)),
    }
    k8 = us(lambda r: wa.mlp_bwd(x, gout, m2, *ln2_fc, 1e-6))
    p8 = us(lambda r: wa.mlp_bwd_plain(x, gout, m2, *ln2_fc, 1e-6))
    plan9 = wa.attn_bwd_plan(torch.bfloat16, 64, C, C // heads, True)
    args9 = ("probe", lib, plan9, x, gout, m1, (w[0], w[1]), *w[2:5], bias, *cfg)
    scratch = wa._attn_bwd_tokens(*args9)
    _, xn_s, go_s, o_s, dqkv_s, dbias_part, ln_part = scratch
    parts9 = {
        "per-window": us(lambda r: wa._attn_bwd_tokens(*args9, parts=1, scratch=scratch)),
        "dx": us(lambda r: wa._attn_bwd_tokens(*args9, parts=2, scratch=scratch)),
        "dWqkv": us(lambda r: wa._wgrad(lib, "probe", xn_s, C, dqkv_s, 3 * C, n_tok, C, 3 * C)),
        "dWproj": us(lambda r: wa._wgrad(lib, "probe", o_s, C, go_s, C, n_tok, C, C)),
        # the tensor-core dx kernel sums go and dqkv itself
        "dbqkv + dbproj (FMA route only)": us(lambda r: (
            wa._wgrad(lib, "probe", None, 0, dqkv_s, 3 * C, n_tok, 1, 3 * C),
            wa._wgrad(lib, "probe", None, 0, go_s, C, n_tok, 1, C))) if plan9[0] == "fma" else 0.0,
        "reduce dbias": us(lambda r: wa._reduce(lib, "probe", dbias_part)),
        "reduce dLN1": us(lambda r: wa._reduce(lib, "probe", ln_part)),
    }
    k9 = us(lambda r: wa.attn_ln1_bwd(x, gout, m1, *w[:5], bias, *cfg))
    p9 = us(lambda r: wa.attn_ln1_bwd_plain(x, gout, m1, *w[:5], bias, *cfg))
    print(f"{line} K8 parts (" + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
          + f") sum {sum(parts.values()):.1f} us; K8 {k8:.1f} us, plain {p8:.1f} us", flush=True)
    print(f"{line} K9 ({plan9[0]}) parts (" + ", ".join(f"{k} {v:.1f}" for k, v in parts9.items())
          + f") sum {sum(parts9.values()):.1f} us; K9 {k9:.1f} us, plain {p9:.1f} us", flush=True)


def main_train(flags):
    if "--fma" in flags:
        flags.remove("--fma")
        tc_mlp, tc_attn, tc_wgrad = wa.mlp_bwd_plan, wa.attn_bwd_plan, wa.wgrad_plan
        wa.mlp_bwd_plan = lambda dtype, *a: tc_mlp(torch.float32, *a)
        wa.attn_bwd_plan = lambda dtype, *a: tc_attn(torch.float32, *a)
        wa.wgrad_plan = lambda dtype, *a: tc_wgrad(torch.float32, *a)
    build("swin_train", flags)
    g = torch.Generator(device="cuda").manual_seed(6)
    ok = all([check_k8(B, H, C, heads, dtype, g) for dtype in (torch.bfloat16, torch.float32)
              for B in (3, 64) for H, C, heads in cs.STAGES])
    ok &= all([check_k9(B, H, C, heads, shift, dtype, g)
               for dtype in (torch.bfloat16, torch.float32) for B in (3, 64)
               for H, C, heads in cs.STAGES for shift in (0, 4)])
    ok &= all([check_k6(B, H, shift, torch.bfloat16, g)
               for B, H, shift in ((3, 8, 0), (64, 8, 0), (64, 8, 4), (3, 16, 4))])
    shapes = sorted({s for _, C, _ in STAGES
                     for s in ((C, 4 * C), (4 * C, C), (C, 3 * C), (C, C))})
    ok &= all([check_wgrad(n_tok, M, Ncol, g) for M, Ncol in shapes
               for n_tok in ((4096, 8200) if M * Ncol <= 96 * 384 else (1000,))])
    for H, C, heads in STAGES:
        time_train(H, C, heads, g)
    print(f"tensor-core launches: K8 {wa.mlp_bwd.tc_launches} of {wa.mlp_bwd.launches}, "
          f"K9 {wa.attn_ln1_bwd.tc_launches} of {wa.attn_ln1_bwd.launches}, "
          f"K6 {wa.window_attention_bwd.tc_launches} of {wa.window_attention_bwd.launches}, "
          f"weight products {wa._wgrad.tc_launches}")
    print("all cases agree" if ok else "SOME CASES DISAGREE")
    sys.exit(0 if ok else 1)


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_window_kernels: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    flags = sys.argv[1:]
    if "--train" in flags:
        flags.remove("--train")
        main_train(flags)
    build("window_attn", flags)
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
