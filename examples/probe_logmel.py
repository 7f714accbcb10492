#!/usr/bin/env python3
"""Quick loop for work on K2 (``zs_aac_tpu_torch/csrc/logmel.cu``) on a CUDA
card, and the split of its time into load, FFT, and power + mel + store.

Run from the repository root: ``python3 examples/probe_logmel.py [--sweep]
[nvcc flag ...]``. It builds the source (with flags: into a temporary
directory) and prints ptxas' registers, spills and shared memory per kernel.

It holds both instantiations, the frame-run kernel (``logmel_plan``'s
choice) and the first kernel (``radix2``, forced), against ``log_mel_plain``
with ``chip_smoke.py``'s tolerance at the encode's shapes (B = 64 ten-second
clips at 32 kHz) and at the 16 kHz and 16-mel configs. It then times, at
the encode's shapes with CUDA events (``chip_smoke.timed_ms``), each
instantiation whole and built twice more with ``-DK2_STOP=1`` (each block
ends after loading its samples) and ``-DK2_STOP=2`` (after the FFT): load =
the first, FFT = the second less the first, power + mel + store = the whole
less the second. The frame-run kernel computes the power in its last FFT
pass: its split is load, FFT + power, mel + store. Beside them: the public
``log_mel`` (the wrapper's host work included), the plain version,
``torch.stft`` (center, reflect, Hann; the STFT part alone) and
``chip_smoke.k2_bound``. With
``--sweep`` it also times the frame-run kernel at other frames per block and
warps per block. About 30 s.

Exit code 1 if a case disagrees.
"""

import ctypes
import dataclasses
import math
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import chip_smoke as cs
from zs_aac_tpu_torch.ops import logmel as lm
from zs_aac_tpu_torch.utils import cuda_build

CONFIGS = {"default": lm.LogMelConfig(),
           "16k": lm.LogMelConfig(sr=16000, n_fft=512, hop_length=160, n_mels=40, f_min=0.0,
                                  f_max=8000.0),
           "16mels": lm.LogMelConfig(n_mels=16)}


def build(flags):
    """``csrc/logmel.cu`` built with extra nvcc ``flags`` into a temporary
    directory, loaded; prints ptxas' report on the kernels."""
    so = os.path.join(tempfile.mkdtemp(), "liblogmel.so")
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o", so,
           str(cuda_build.CSRC / "logmel.cu")]
    done = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode:
        sys.exit(done.stdout)
    print(f"[build] {' '.join(flags) or 'as committed'}", flush=True)
    for line in done.stdout.splitlines():
        if "Function properties" not in line and "Compiling entry" not in line:
            print("   " + line.strip()[:160])
    return ctypes.CDLL(so)


def use(lib):
    cuda_build._LIBS["logmel"] = lib


def radix2_plan(cfg):
    return lm.LogMelPlan("radix2", 1, 8, 8 * cfg.n_fft, 1)


def main():
    args = sys.argv[1:]
    sweep = "--sweep" in args
    flags = [a for a in args if a != "--sweep"]
    print(f"{torch.cuda.get_device_name(0)}", flush=True)
    whole = build(flags)
    use(whole)
    ok = True
    g = torch.Generator(device="cuda").manual_seed(5)
    B, T = 64, 320000
    for name, cfg in CONFIGS.items():
        w = torch.randn(B, T, generator=g, device="cuda") * 0.1
        want = lm.log_mel_plain(w, cfg)
        for kind, plan in (("frames", lm.logmel_plan(cfg, B, T)), ("radix2", radix2_plan(cfg))):
            err = (lm._launch(w, cfg, plan) - want).abs().max().item()
            print(f"[check] {name} B={B} T={T} {kind} {plan}: max|dB - dB_plain| {err:.3g} "
                  f"(tol {cs.K2_TOL})", flush=True)
            ok &= err <= cs.K2_TOL

    cfg = CONFIGS["default"]
    t = torch.arange(T, device="cuda") / 32000.0
    freqs = torch.rand(B, 1, generator=g, device="cuda") * 4000 + 100
    waves = (0.3 * torch.sin(2 * math.pi * freqs * t)
             + 0.05 * torch.randn(B, T, generator=g, device="cuda"))
    plans = {"frames": lm.logmel_plan(cfg, B, T), "radix2": radix2_plan(cfg)}
    bound, by = cs.k2_bound(B, T, cfg)
    stop = {s: build([*flags, f"-DK2_STOP={s}"]) for s in (1, 2)}
    for kind, plan in plans.items():
        t = {}
        for part, lib in ((1, stop[1]), (2, stop[2]), (3, whole)):
            use(lib)
            lm._launch(waves, cfg, plan)
            t[part] = cs.timed_ms(lambda r: lm._launch(waves, cfg, plan), 20)
        parts = (("FFT + power", "mel + store") if kind == "frames"
                 else ("FFT", "power + mel + store"))
        print(f"[time] {kind} {plan}: {t[3] * 1e3:.1f} us (bound {bound * 1e3:.1f} us by {by}, "
              f"{bound / t[3]:.1%}); load {t[1] * 1e3:.1f}, {parts[0]} "
              f"{(t[2] - t[1]) * 1e3:.1f}, {parts[1]} {(t[3] - t[2]) * 1e3:.1f}", flush=True)
    use(whole)
    plain = cs.timed_ms(lambda r: lm.log_mel_plain(waves, cfg), 5)
    win = torch.hann_window(cfg.n_fft, periodic=True, device="cuda")
    stft = lambda r: torch.stft(waves, cfg.n_fft, cfg.hop_length, window=win, center=True,
                                pad_mode="reflect", return_complex=True)
    stft(0)
    public = cs.timed_ms(lambda r: lm.log_mel(waves, cfg), 20)
    print(f"[time] frames through the public log_mel (autograd Function, plan and checks "
          f"on the host each call): {public * 1e3:.1f} us", flush=True)
    print(f"[time] plain {plain * 1e3:.1f} us; torch.stft (the STFT part alone) "
          f"{cs.timed_ms(stft, 10) * 1e3:.1f} us", flush=True)
    if sweep:
        for warps in (4, 8):
            for frames in (8, 12, 16, 24, 32, 64):
                smem = lm._frames_smem(cfg, frames, warps)
                if smem > lm._SMEM_LIMIT:
                    continue
                plan = dataclasses.replace(plans["frames"], frames=frames, warps=warps, smem=smem)
                err = (lm._launch(waves, cfg, plan) - lm.log_mel_plain(waves, cfg)).abs().max()
                ok &= err.item() <= cs.K2_TOL
                ms = cs.timed_ms(lambda r: lm._launch(waves, cfg, plan), 20)
                print(f"[sweep] frames {frames} warps {warps} smem {smem}: {ms * 1e3:.1f} us, "
                      f"max|dB - dB_plain| {err.item():.3g}", flush=True)
    print("ok" if ok else "MISMATCH", flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
