#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``zs_aac_tpu_torch``) on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py`` (one card; the
kernels build with nvcc at first use, one nvcc per source, in parallel). It
fails, printing no result, where CUDA is not available. Phases, each of
which must pass:

1. build every kernel: K1 (``csrc/decode_attn.cu``), K2 (``csrc/logmel.cu``)
   and K3/K5 (``csrc/window_attn.cu``), with each nvcc's time;
2. hold K1 against its plain PyTorch version at the main path's shapes
   (B=256, H=12, d=64, T=77) and at edge shapes (B=1, d=16), fp32 and bf16;
3. exact captions on learned weights: the port's ``predict_prompt`` on the
   committed tiny captioner (greedy and ``--q8``) reproduces the captions
   the JAX package recorded;
4. the decode half at full width: CLAP embedding -> MLP mapper
   1024->3840->7680 -> GPT-2 124M (seeded random weights), B=256, Lp=10, 67
   greedy steps, bf16 activations, w8a8 weights + int8 KV cache, every
   attention through K1 (launch count checked). Kernel and plain attention
   are teacher-forced on one token stream and their logits compared;
   captions/s and K1's time per call beside its byte bound are measured
   with CUDA events, and a ``torch.profiler`` table of one decode printed;
5. K2 (log-mel) against its plain version at B=64 x 10 s and at edge shapes
   (B=1, odd T, T near n_fft, silence, a pure tone);
6. K3 (whole Swin block) against its plain version at HTSAT's three stage
   shapes, shifted and unshifted, fp32 and bf16, and at the stage-4 shape in
   bf16 (the function of the TPU's streamed kernel K4); K5 (window
   attention) at the stage-4 shape and a shifted stage-1 shape; a refused
   launch (head dim 96) must raise;
7. exact embeddings on learned weights: the port's ``load_ase_encoders`` +
   ``extract_audio_text_bank`` on the committed tiny ASE (fp32) reproduce
   the JAX-recorded audio and text embeddings, with K2, K3 and K5 launched;
8. the encode half at full width (``configs/extract_data.yaml``'s geometry,
   seeded random weights, bf16): B=64 ten-second waves -> K2 -> HTSAT
   (K3 in stages 1-3, K5 + PyTorch MLP in stage 4) -> projection ->
   [64, 1024] L2-normalized embeddings. Launch counts per encode are checked
   (K2 1, K3 10, K5 2), the embeddings are compared row by row with the
   all-plain path's (cosine), clips/s and BERT-base texts/s are measured
   with CUDA events, each kernel's time per call is set beside its bound,
   and a ``torch.profiler`` table of one encode is printed.

The last lines are the ``kernels`` JSON line, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

# Tolerances. K1 and its plain version run the same arithmetic in another
# summation order, so fp32 outputs agree to ~1e-5 of |o| <= 4; in bf16 the
# reference's activation-dtype roundings (scores, probabilities, output) can
# land one bf16 step apart (2**-8 relative), and one such step at |o| ~ 4 is
# 0.016. The cache row and scales come from identical ops: bytewise equal.
K1_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# Teacher-forced full-width logits (|logit| <= ~3): one-step bf16 differences
# in attention outputs shift w8a8 activation quantization by at most one int8
# step here and there, which moves logits by a few hundredths.
LOGIT_TOL = 0.25
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12         # fp32 outside the tensor cores
H100_BF16_FLOPS = 989e12        # bf16 dense tensor-core peak
# K2 vs plain, log-mel dB: both fp32 FFTs differing in summation order; on
# noise every mel bin is far above the rounding floor (~1e-12 of the peak
# power), where 1e-6 relative in power is 4e-6 dB. For a pure tone, bins
# far under the peak hold only window leakage, where the FFTs' rounding
# (~1e-7 of the peak amplitude) is a relative error of ~2e-7 * sqrt(peak /
# power): 60-90 dB down it is held to 0.1 dB, and below that the bins need
# only stay under peak - 80 dB.
K2_TOL = 2e-3
K2_TONE_MID_TOL = 0.1
# K3/K5 vs plain: fp32 differs in summation order only (outputs ~8-30, fc
# sums over up to 3072 hidden units): 2e-4 absolute. bf16 rounds at the same
# points, where an fp32 accumulator's last bit can flip one bf16 rounding,
# and a flipped residual input can flip the output's: two bf16 steps at the
# largest output, 2**-6 * max|out_plain|.
def window_tol(name, ref):
    return 2e-4 if name == "float32" else 2.0 ** -6 * ref.float().abs().max().item()
# Tiny-ASE fixture on the card (fp32, TF32 off) vs the JAX-recorded
# embeddings (L2-normalized, entries ~0.2): summation order only.
FIXTURE_TOL = 1e-4
# Full-width bf16 encode, kernel path vs all-plain path: per-row cosine of
# the [64, 1024] embeddings. The paths round to bf16 at different points
# (the plain MLPs of stages 1-3 round each matmul output and then its bias
# add), so 12 blocks of bf16 noise separate them; 0.99 is far above what
# any indexing or layout error leaves (~0 for unrelated embeddings).
COSINE_MIN = 0.99


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def timed_ms(fn, reps):
    """Mean ms of ``fn(r)`` for r = 0..reps-1, by CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for r in range(reps):
        fn(r)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_inputs(B, H, T, d, dtype, g):
    import torch

    dev = "cuda"
    return [
        torch.randn(B, H, d, generator=g, device=dev).to(dtype),
        (torch.randn(B, H, d, generator=g, device=dev) * 2).to(dtype),
        torch.randn(B, H, d, generator=g, device=dev).to(dtype),
        torch.randint(-127, 128, (B, H, T, d), generator=g, device=dev, dtype=torch.int8),
        torch.randint(-127, 128, (B, H, T, d), generator=g, device=dev, dtype=torch.int8),
        torch.rand(B, H, T, generator=g, device=dev) * 0.05 + 1e-3,
        torch.rand(B, H, T, generator=g, device=dev) * 0.05 + 1e-3,
    ]


def k1_bound(B, H, d, index, act_bytes):
    """Least time of one K1 call: q/k/v read and o written in the activation
    dtype, rows 0..index-1 of int8 K, V and their fp32 scales read, row
    ``index`` and its scales written; 4*d flops per valid row."""
    nbytes = B * H * (4 * d * act_bytes + (index + 1) * (2 * d + 8))
    flops = 4.0 * B * H * (index + 1) * d
    return max(nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOPS) * 1e3, nbytes


def phase_build():
    from zs_aac_tpu_torch.utils import cuda_build

    names = ["decode_attn", "logmel", "window_attn"]
    report = cuda_build.build(names)
    for name in names:
        if name in report:
            seconds, nvcc_out = report[name]
            print(f"[build] csrc/{name}.cu: nvcc {seconds:.2f} s\n{nvcc_out.strip()}",
                  flush=True)
        else:
            print(f"[build] csrc/{name}.cu: already built", flush=True)


def phase_k1_vs_plain():
    import torch

    from zs_aac_tpu_torch.ops.decode_attn import decode_attn_q8, decode_attn_q8_plain

    g = torch.Generator(device="cuda").manual_seed(1)
    worst = {}
    cases = [(256, 12, 77, 64, i) for i in (0, 10, 40, 76)] + \
            [(1, 4, 13, 16, i) for i in (0, 6, 12)]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for B, H, T, d, index in cases:
            a = k1_inputs(B, H, T, d, dtype, g)
            b = [x.clone() for x in a]
            o = decode_attn_q8(*a, index)
            o_ref = decode_attn_q8_plain(*b, index)
            torch.cuda.synchronize()
            err = (o.float() - o_ref.float()).abs().max().item()
            same = all(torch.equal(x, y) for x, y in zip(a[3:], b[3:]))
            print(f"[k1] {name} B={B} H={H} T={T} d={d} index={index}: "
                  f"max|o-o_plain|={err:.3g} (tol {K1_TOL[name]}), cache bytes equal={same}",
                  flush=True)
            check(err <= K1_TOL[name], f"K1 disagrees with its plain version ({err})")
            check(same, "K1's cache row or scales differ from the plain version's")
            if B == 256:
                worst[name] = max(worst.get(name, 0.0), err)
    return worst


def phase_fixture_captions():
    import torch

    from zs_aac_tpu_torch.ops.decode_attn import decode_attn_q8
    from zs_aac_tpu_torch.testdata import stage_tiny_captioner
    from zs_aac_tpu_torch.train.predict_prompt import main as predict

    for mode, flags in (("greedy", []), ("q8", ["--q8"])):
        with tempfile.TemporaryDirectory() as tmp:
            staged = stage_tiny_captioner(tmp)
            decode_attn_q8.launches = 0
            predict(["--test_dir", staged["run_dir"], "--data", staged["test_bank"],
                     "--device", "cuda"] + flags)
            launches = decode_attn_q8.launches
            with open(f"{staged['run_dir']}/output.txt") as f:
                got = {p["filename"]: p["caption"] for p in json.load(f)["predictions"]}
        want = staged["expected"][mode]
        n_same = sum(got.get(k) == v for k, v in want.items())
        print(f"[fixture] predict_prompt {mode} on cuda: {n_same}/{len(want)} captions "
              f"equal to the JAX package's, K1 launches {launches}", flush=True)
        check(got == want, f"{mode} captions differ from the recorded ones")
        check((launches > 0) == (mode == "q8"), f"{mode}: unexpected K1 launches {launches}")


def phase_full_width():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zs_aac_tpu_torch.decoding.greedy import CHECK_EVERY, greedy_decode, greedy_decode_q8
    from zs_aac_tpu_torch.models.caption import (CaptionConfig, caption_embeddings,
                                                 init_caption_model)
    from zs_aac_tpu_torch.models.convert import cast_floating
    from zs_aac_tpu_torch.models.gpt2 import (GPT2Config, gpt2_embed, gpt2_prefill_q8,
                                              gpt2_step_q8, init_kv_cache_q8,
                                              quantize_gpt2_int8)
    from zs_aac_tpu_torch.ops.decode_attn import decode_attn_q8, decode_attn_q8_plain

    B, Lp, steps = 256, 10, 67
    cfg = CaptionConfig(prefix_length=Lp, prefix_size=1024, gpt2=GPT2Config())
    gcfg = cfg.gpt2
    H, d = gcfg.n_head, gcfg.n_embd // gcfg.n_head
    with torch.no_grad():
        params = init_caption_model(cfg, seed=0, device="cuda")
        gp_bf16 = cast_floating(params["gpt2"], torch.bfloat16)
        qp = quantize_gpt2_int8(gp_bf16, "w8a8")
        g = torch.Generator(device="cuda").manual_seed(2)
        prefix = torch.randn(B, cfg.prefix_size, generator=g, device="cuda")
        emb = caption_embeddings(params, cfg, prefix).to(torch.bfloat16)
    check(tuple(emb.shape) == (B, Lp, 768), f"prefix embeddings {tuple(emb.shape)}")

    def decode():
        return greedy_decode_q8(qp, gcfg, emb, steps, 13, 764)

    decode()                                    # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    # the main path, counted: K1 launches between these two reads
    decode_attn_q8.launches = 0
    t0 = time.perf_counter()
    toks, lens = decode()
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    launches = decode_attn_q8.launches
    max_len = int(lens.max())
    steps_run = min(steps, math.ceil(max_len / CHECK_EVERY) * CHECK_EVERY)
    print(f"[full] w8a8+q8 greedy B={B} Lp={Lp}: lengths min/max {int(lens.min())}/{max_len}, "
          f"steps run {steps_run}, K1 launches {launches} "
          f"(expected {gcfg.n_layer} x {steps_run})", flush=True)
    check(launches == gcfg.n_layer * steps_run, "K1 launch count off the main path's")
    check(bool(((toks >= 0) & (toks < gcfg.vocab_size)).all()), "token ids out of range")
    for _ in range(2):
        t0 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print(f"[full] decode walls {[round(w * 1e3, 2) for w in walls]} ms -> "
          f"{B / wall:.1f} captions/s (median; {steps_run} steps)", flush=True)

    # free-running agreement with the plain attention (information only)
    toks_plain, _ = greedy_decode_q8(qp, gcfg, emb, steps, 13, 764,
                                     attention=decode_attn_q8_plain)
    agree = (toks_plain == toks).float().mean().item()
    print(f"[full] free-running greedy token agreement, K1 vs plain: {agree:.4f}", flush=True)

    # teacher-forced, step-locked logits: kernel path vs plain path
    with torch.no_grad():
        caches = [init_kv_cache_q8(gcfg, B, Lp + steps) for _ in range(2)]
        lk, caches[0] = gpt2_prefill_q8(qp, gcfg, emb, caches[0])
        _, caches[1] = gpt2_prefill_q8(qp, gcfg, emb, caches[1])
        dmax, flip_margin, n_flips, lmax = 0.0, 0.0, 0, float(lk.float().abs().max())
        for i in range(steps - 1):
            x = gpt2_embed(qp, toks[:, i])
            lk, caches[0] = gpt2_step_q8(qp, gcfg, x, caches[0], Lp + i)
            lp, caches[1] = gpt2_step_q8(qp, gcfg, x, caches[1], Lp + i,
                                         attention=decode_attn_q8_plain)
            dmax = max(dmax, (lk - lp).abs().max().item())
            lmax = max(lmax, lp.abs().max().item())
            top2 = lp.topk(2, dim=-1).values
            flips = lk.argmax(-1) != lp.argmax(-1)
            if flips.any():
                n_flips += int(flips.sum())
                flip_margin = max(flip_margin, (top2[:, 0] - top2[:, 1])[flips].max().item())
    print(f"[full] teacher-forced logits, K1 vs plain: max|diff| {dmax:.4g} "
          f"(tol {LOGIT_TOL}; max|logit| {lmax:.3g}), argmax flips {n_flips} of "
          f"{B * (steps - 1)}, largest top-2 margin at a flip {flip_margin:.4g}", flush=True)
    check(dmax <= LOGIT_TOL, "teacher-forced logits diverge beyond the bf16 tolerance")
    check(n_flips == 0 or flip_margin <= 2 * dmax,
          "an argmax flip at a top-2 margin larger than the logit divergence")

    # K1 alone at the decode's shapes, every index the 67 steps use. Calls
    # rotate over 4 input sets (4 x 30 MB of cache, more than the 50 MB L2),
    # so each call reads its rows from HBM, as a layer's call does in the
    # decode, where the other layers' caches and weights pass in between.
    g = torch.Generator(device="cuda").manual_seed(3)
    bufs = [k1_inputs(B, H, Lp + steps, d, torch.bfloat16, g) for _ in range(4)]
    kms, pms, bms, nbytes = [], [], [], []
    for index in range(Lp, Lp + steps):
        decode_attn_q8(*bufs[0], index)
        kms.append(timed_ms(lambda r: decode_attn_q8(*bufs[r % 4], index), 20))
        pms.append(timed_ms(lambda r: decode_attn_q8_plain(*bufs[r % 4], index), 4))
        bm, nb = k1_bound(B, H, d, index, 2)
        bms.append(bm)
        nbytes.append(nb)
    k1 = {"ms": statistics.mean(kms), "plain_ms": statistics.mean(pms),
          "bound_ms": statistics.mean(bms)}
    print(f"[full] K1 per call, mean over index {Lp}..{Lp + steps - 1} at B={B} bf16: "
          f"{k1['ms'] * 1e3:.2f} us (bound {k1['bound_ms'] * 1e3:.2f} us, "
          f"{statistics.mean(nbytes) / 1e6:.2f} MB at {H100_BYTES_PER_S / 1e12} TB/s; "
          f"{k1['bound_ms'] / k1['ms']:.1%} of bound), plain {k1['plain_ms'] * 1e3:.2f} us; "
          f"first/last index {kms[0] * 1e3:.2f}/{kms[-1] * 1e3:.2f} us", flush=True)
    print(f"[full] K1 share of one decode: {launches} x {k1['ms']:.4f} ms = "
          f"{launches * k1['ms']:.2f} ms of {wall * 1e3:.2f} ms", flush=True)

    # the float path (bf16 weights, bf16 cache; no kernel) for reference
    greedy_decode(gp_bf16, gcfg, emb, steps, 13, 764)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greedy_decode(gp_bf16, gcfg, emb, steps, 13, 764)
    torch.cuda.synchronize()
    fwall = time.perf_counter() - t0
    print(f"[full] bf16 float path (no K1): {fwall * 1e3:.2f} ms -> {B / fwall:.1f} captions/s",
          flush=True)

    # where one w8a8+q8 decode spends its device time
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    print(f"[profile] one decode under torch.profiler: wall {pwall * 1e3:.2f} ms", flush=True)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15), flush=True)
    return launches, k1

# -- the encode half ----------------------------------------------------------

# configs/extract_data.yaml's encoder settings (the card machine has no yaml
# reader; tests/test_torch_extract.py holds this copy to the file).
EXTRACT_CONFIG = {
    "audio_args": {"sr": 32000, "n_fft": 1024, "hop_length": 320, "f_min": 50,
                   "f_max": 14000, "n_mels": 64, "max_length": 10, "mono": True},
    "audio_encoder_args": {"type": "transformer", "model": "HTSAT", "pretrained": False,
                           "freeze": True},
    "text_encoder_args": {"type": "bert-base-uncased", "freeze": True},
    "embed_size": 1024,
    "temp": 0.07,
    "embed_regularization": True,
    "training": {"spec_augmentation": False, "epochs": 1},
    "compute_dtype": "bfloat16",
}


def k2_bound(B, T, cfg):
    """Least time of one K2 call: the wave read and the log-mel written once
    (bytes), against a real FFT's 2.5 n log2 n flops per frame plus the
    power and the mel sums (fp32)."""
    from zs_aac_tpu_torch.ops.logmel import mel_filterbank, num_frames

    F = num_frames(T, cfg)
    nbytes = 4 * B * T + 4 * B * F * cfg.n_mels
    nnz = int((mel_filterbank(cfg.sr, cfg.n_fft, cfg.n_mels, cfg.f_min, cfg.f_max) != 0).sum())
    n = cfg.n_fft
    flops = B * F * (2.5 * n * math.log2(n) + 3 * (n // 2 + 1) + 2 * nnz)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def window_bound(B, H, C, heads, window, itemsize, mlp):
    """Least time of one K3 (mlp) or K5 call, per-head formulation: qkv,
    scores, p.v and projection (plus fc1/fc2 with hidden 4C) flops against
    x read, out written, weights and bias read once."""
    tokens, N = B * H * H, window * window
    flops = tokens * (2 * C * 4 * C + 4 * N * C + (2 * C * 8 * C if mlp else 0))
    weights = (4 * C * C + (8 * C * C if mlp else 0)) * itemsize
    nwin = (H // window) ** 2
    nbytes = 2 * tokens * C * itemsize + weights + nwin * heads * N * N * 4
    peak = H100_BF16_FLOPS if itemsize == 2 else H100_FP32_FLOPS
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_k2_vs_plain():
    import torch

    from zs_aac_tpu_torch.ops.logmel import LogMelConfig, log_mel, log_mel_plain

    cfg = LogMelConfig()
    g = torch.Generator(device="cuda").manual_seed(4)
    worst = 0.0
    for B, T in [(64, 320000), (1, 320000), (1, 16001), (3, 7777), (1, 1025), (1, 1000)]:
        w = torch.randn(B, T, generator=g, device="cuda") * 0.1
        err = (log_mel(w, cfg) - log_mel_plain(w, cfg)).abs().max().item()
        print(f"[k2] noise B={B} T={T}: max|dB - dB_plain| = {err:.3g} (tol {K2_TOL})",
              flush=True)
        check(err <= K2_TOL, f"K2 disagrees with its plain version ({err} dB)")
        if B == 64:
            worst = err
    silence = torch.zeros(2, 32000, device="cuda")
    check(bool((log_mel(silence, cfg) == -100.0).all()), "K2: silence is not -100 dB everywhere")
    t = torch.arange(64000, device="cuda") / 32000.0
    for freq in (440.0, 1000.0, 7919.0):
        tone = (0.5 * torch.sin(2 * math.pi * freq * t))[None]
        got, want = log_mel(tone, cfg), log_mel_plain(tone, cfg)
        peak = want.max()
        loud = want > peak - 60.0
        mid = (want <= peak - 60.0) & (want > peak - 90.0)
        quiet = want <= peak - 90.0
        err_loud = (got - want)[loud].abs().max().item()
        err_mid = (got - want)[mid].abs().max().item() if mid.any() else 0.0
        check(err_loud <= K2_TOL and err_mid <= K2_TONE_MID_TOL,
              f"K2 tone {freq} Hz: {err_loud} dB (loud bins), {err_mid} dB (-60..-90 dB)")
        check(bool((got[quiet] < peak - 80).all()), f"K2 tone {freq} Hz: leakage bins too loud")
    print("[k2] silence = -100 dB everywhere; pure tones 440/1000/7919 Hz within "
          f"{K2_TOL} dB of the plain version within 60 dB of the peak, {K2_TONE_MID_TOL} dB "
          "60-90 dB down", flush=True)
    return worst


def _window_case(B, H, C, heads, window, dtype, g, hidden=None):
    import torch

    hidden = hidden or 4 * C
    nH, N = H // window, window * window
    f = lambda *shape: torch.randn(*shape, generator=g, device="cuda") * 0.05
    x = (f(B, H, H, C) * 20).to(dtype)
    w = [f(C) + 1, f(C), f(C, 3 * C), f(3 * C), f(C, C), f(C), f(C) + 1, f(C),
         f(C, hidden), f(hidden), f(hidden, C), f(C)]
    bias = torch.randn(nH, nH, heads, N, N, generator=g, device="cuda")
    return x, [t.to(dtype) for t in w], bias


STAGES = [(64, 96, 4), (32, 192, 8), (16, 384, 16)]   # (H=W, C, heads) at B=64, window 8


def phase_window_vs_plain():
    import torch

    from zs_aac_tpu_torch.ops.window_attn import (fused_swin_block, fused_window_attention,
                                                  swin_block_plain, window_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(5)
    worst = {"k3": 0.0, "k4": 0.0, "k5": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for H, C, heads in STAGES:
            for shift in (0, 4):
                x, w, bias = _window_case(64, H, C, heads, 8, dtype, g)
                ref = swin_block_plain(x, *w, bias, 8, heads, shift, 1e-6)
                err = (fused_swin_block(x, *w, bias, 8, heads, shift, 1e-6).float()
                       - ref.float()).abs().max().item()
                tol = window_tol(name, ref)
                print(f"[k3] {name} B=64 {H}x{H}x{C} heads={heads} shift={shift}: "
                      f"max|out-out_plain| = {err:.3g} (tol {tol:.3g})", flush=True)
                check(err <= tol, f"K3 disagrees with its plain version ({err})")
                if dtype == torch.bfloat16:
                    worst["k3"] = max(worst["k3"], err)
    # K4's function: stage 4 (8x8x768, 32 heads, hidden 3072) through K3, bf16
    x, w, bias = _window_case(64, 8, 768, 32, 8, torch.bfloat16, g)
    ref = swin_block_plain(x, *w, bias, 8, 32, 0, 1e-6)
    err = (fused_swin_block(x, *w, bias, 8, 32, 0, 1e-6).float() - ref.float()).abs().max().item()
    tol = window_tol("bfloat16", ref)
    print(f"[k4] bf16 B=64 8x8x768 heads=32 hidden=3072 through K3: max|out-out_plain| = "
          f"{err:.3g} (tol {tol:.3g})", flush=True)
    check(err <= tol, f"K3 at K4's shape disagrees ({err})")
    worst["k4"] = err
    for dtype, (H, C, heads), shift in ((torch.bfloat16, (8, 768, 32), 0),
                                        (torch.float32, (8, 384, 16), 0),
                                        (torch.bfloat16, (64, 96, 4), 4),
                                        (torch.float32, (64, 96, 4), 4)):
        name = str(dtype).split(".")[1]
        x, w, bias = _window_case(64, H, C, heads, 8, dtype, g)
        ref = window_attention_plain(x, *w[2:6], bias, 8, heads, shift)
        err = (fused_window_attention(x, *w[2:6], bias, 8, heads, shift).float()
               - ref.float()).abs().max().item()
        tol = window_tol(name, ref)
        print(f"[k5] {name} B=64 {H}x{H}x{C} heads={heads} shift={shift}: "
              f"max|out-out_plain| = {err:.3g} (tol {tol:.3g})", flush=True)
        check(err <= tol, f"K5 disagrees with its plain version ({err})")
        if dtype == torch.bfloat16 and H == 8:
            worst["k5"] = err
    x, w, bias = _window_case(2, 8, 192, 2, 8, torch.float32, g)   # head dim 96
    try:
        fused_window_attention(x, *w[2:6], bias, 8, 2, 0)
    except ValueError as e:
        print(f"[k5] refused as it should be: {e}", flush=True)
    else:
        check(False, "K5 took a head dim of 96")
    return worst


def phase_fixture_bank():
    import torch

    from zs_aac_tpu_torch.ops.logmel import log_mel
    from zs_aac_tpu_torch.ops.window_attn import fused_swin_block, fused_window_attention
    from zs_aac_tpu_torch.pipeline.extract import extract_audio_text_bank, load_ase_encoders
    from zs_aac_tpu_torch.testdata import stage_tiny_ase

    with tempfile.TemporaryDirectory() as tmp:
        staged = stage_tiny_ase(tmp)
        ea, et = load_ase_encoders(staged["config"], staged["ckpt"], device="cuda")
        for fn in (log_mel, fused_swin_block, fused_window_attention):
            fn.launches = 0
        got = extract_audio_text_bank(ea, et, staged["data_path"], True,
                                      staged["config"]["audio_args"], batch_size=4)
        launches = [log_mel.launches, fused_swin_block.launches, fused_window_attention.launches]
    want = staged["expected"]
    check(len(got) == len(want), f"fixture: {len(got)} records, {len(want)} recorded")
    err = 0.0
    for gr, wr in zip(got, want):
        check(gr["audio_id"] == wr["audio_id"] and gr["caption"] == wr["caption"],
              "fixture: record order or captions differ")
        for key in ("audio_embedding", "text_embedding"):
            err = max(err, float(abs(torch.as_tensor(gr[key]).float()
                                     - torch.tensor(wr[key])).max()))
    print(f"[fixture] tiny ASE bank on cuda: {len(got)} records, max|emb - emb_JAX| = "
          f"{err:.3g} (tol {FIXTURE_TOL}); launches K2/K3/K5 = {launches}", flush=True)
    check(err <= FIXTURE_TOL, "fixture embeddings differ from the JAX-recorded ones")
    check(all(n > 0 for n in launches), f"fixture path missed a kernel: {launches}")


def phase_encode_full_width():
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from zs_aac_tpu_torch.models.ase import ASE, init_ase
    from zs_aac_tpu_torch.models.convert import cast_floating
    from zs_aac_tpu_torch.ops.logmel import LogMelConfig, log_mel, log_mel_plain
    from zs_aac_tpu_torch.ops.window_attn import (build_window_bias, fused_swin_block,
                                                  fused_window_attention, swin_block_plain,
                                                  window_attention_plain)
    from zs_aac_tpu_torch.pipeline.extract import build_ase_from_config
    from zs_aac_tpu_torch.train.contrastive import make_encode_fns

    B, T = 64, 10 * 32000
    _, cfg = build_ase_from_config(EXTRACT_CONFIG)
    mel_cfg = LogMelConfig.from_dict(EXTRACT_CONFIG["audio_args"])
    with torch.no_grad():
        variables = cast_floating(init_ase(cfg, seed=0, device="cuda"), torch.bfloat16)
    n_stages = len(ASE(cfg).audio_enc.depths)
    kernel_ase = ASE(dataclasses.replace(cfg, fused_attn=True,
                                         fused_block=tuple(range(n_stages - 1))))
    plain_ase = ASE(dataclasses.replace(cfg, fused_attn=False, fused_block=False))
    enc_a, enc_t = make_encode_fns(kernel_ase, mel_cfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(6)
    t = torch.arange(T, device="cuda") / 32000.0
    freqs = torch.rand(B, 1, generator=g, device="cuda") * 4000 + 100
    waves = (0.3 * torch.sin(2 * math.pi * freqs * t)
             + 0.05 * torch.randn(B, T, generator=g, device="cuda"))

    enc_a(variables, waves)                     # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    kernels = {"K2": log_mel, "K3": fused_swin_block, "K5": fused_window_attention}
    for fn in kernels.values():
        fn.launches = 0
    emb = enc_a(variables, waves)               # the main path, counted
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    print(f"[encode] B={B} 10 s clips, bf16, seeded weights: embeddings "
          f"{tuple(emb.shape)} {emb.dtype}; launches per encode {launches} "
          "(expected K2 1, K3 10, K5 2)", flush=True)
    check(launches == {"K2": 1, "K3": 10, "K5": 2}, "encode launch counts off the main path's")
    check(tuple(emb.shape) == (B, 1024) and bool(torch.isfinite(emb.float()).all()),
          "encode output is not a finite [64, 1024]")
    norms = emb.float().norm(dim=-1)
    check(bool(((norms - 1).abs() < 1e-2).all()), "embeddings are not L2-normalized")
    with torch.no_grad():
        emb_plain = plain_ase.encode_audio(variables, log_mel_plain(waves, mel_cfg)[:, 0])
    cos = torch.nn.functional.cosine_similarity(emb.float(), emb_plain.float(), dim=-1)
    print(f"[encode] kernel path vs all-plain path: per-row cosine min {cos.min().item():.5f} "
          f"mean {cos.mean().item():.5f} (threshold {COSINE_MIN}); max|diff| "
          f"{(emb.float() - emb_plain.float()).abs().max().item():.3g}", flush=True)
    check(cos.min().item() >= COSINE_MIN, "kernel-path embeddings diverge from the plain path")

    enc_ms = statistics.median(timed_ms(lambda r: enc_a(variables, waves), 1) for _ in range(3))
    with torch.no_grad():
        plain_ms = timed_ms(lambda r: plain_ase.encode_audio(
            variables, log_mel_plain(waves, mel_cfg)[:, 0]), 2)
    print(f"[encode] wave -> embedding at B={B}: {enc_ms:.2f} ms per batch -> "
          f"{B / enc_ms * 1e3:.1f} clips/s (kernel path; waves already on the card); "
          f"all-plain path {plain_ms:.2f} ms -> {B / plain_ms * 1e3:.1f} clips/s", flush=True)

    L = 30
    ids = torch.randint(1000, 30000, (B, L), generator=g, device="cuda")
    mask = torch.ones(B, L, dtype=torch.int64, device="cuda")
    lens = torch.randint(6, L + 1, (B,), generator=g, device="cuda")
    mask[torch.arange(L, device="cuda")[None] >= lens[:, None]] = 0
    ids[:, 0] = 101
    temb = enc_t(variables, ids, mask)
    check(tuple(temb.shape) == (B, 1024) and bool(torch.isfinite(temb.float()).all()),
          "text embeddings are not a finite [64, 1024]")
    text_ms = statistics.median(timed_ms(lambda r: enc_t(variables, ids, mask), 3)
                                for _ in range(3))
    print(f"[encode] BERT-base encode_text at B={B}, L={L}, bf16: {text_ms:.2f} ms per batch "
          f"-> {B / text_ms * 1e3:.1f} texts/s", flush=True)

    # each kernel alone at the encode's shapes, beside its plain version and bound
    stats = {}
    k2_ms = timed_ms(lambda r: log_mel(waves, mel_cfg), 10)
    k2_plain = timed_ms(lambda r: log_mel_plain(waves, mel_cfg), 5)
    k2_b, k2_by = k2_bound(B, T, mel_cfg)
    stats["K2"] = {"ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_b, "bound_by": k2_by}
    print(f"[encode] K2 B={B} T={T}: {k2_ms * 1e3:.1f} us (bound {k2_b * 1e3:.1f} us by {k2_by}, "
          f"{k2_b / k2_ms:.1%}), plain {k2_plain * 1e3:.1f} us", flush=True)
    gw = torch.Generator(device="cuda").manual_seed(7)
    per_call = {"K3": [], "K5": []}
    for (H, C, heads), n_calls in zip(STAGES + [(8, 768, 32)], (2, 2, 6, 2)):
        x, w, _ = _window_case(B, H, C, heads, 8, torch.bfloat16, gw)
        rpb = torch.randn(heads, 64, 64, generator=gw, device="cuda")
        bias = build_window_bias(rpb, None, H // 8, H // 8)
        mlp = H > 8
        if mlp:
            fn = lambda r: fused_swin_block(x, *w, bias, 8, heads, 0, 1e-6)
            pf = lambda r: swin_block_plain(x, *w, bias, 8, heads, 0, 1e-6)
        else:
            fn = lambda r: fused_window_attention(x, *w[2:6], bias, 8, heads, 0)
            pf = lambda r: window_attention_plain(x, *w[2:6], bias, 8, heads, 0)
        fn(0)
        ms, pms = timed_ms(fn, 5), timed_ms(pf, 3)
        bms, by = window_bound(B, H, C, heads, 8, 2, mlp)
        key = "K3" if mlp else "K5"
        per_call[key] += [(ms, pms, bms, by)] * n_calls
        print(f"[encode] {key} B={B} {H}x{H}x{C} heads={heads} bf16: {ms * 1e3:.1f} us per call "
              f"x {n_calls} per encode (bound {bms * 1e3:.1f} us by {by}, {bms / ms:.1%}), "
              f"plain {pms * 1e3:.1f} us", flush=True)
        if not mlp:   # K4's function: the same stage-4 block through K3
            k4 = lambda r: fused_swin_block(x, *w, bias, 8, heads, 0, 1e-6)
            k4_ms = timed_ms(k4, 5)
            k4_pms = timed_ms(lambda r: swin_block_plain(x, *w, bias, 8, heads, 0, 1e-6), 3)
            k4_b, k4_by = window_bound(B, H, C, heads, 8, 2, True)
            stats["K4"] = {"ms": k4_ms, "plain_ms": k4_pms, "bound_ms": k4_b, "bound_by": k4_by}
            print(f"[encode] K4's function (stage-4 whole block through K3) B={B}: "
                  f"{k4_ms * 1e3:.1f} us (bound {k4_b * 1e3:.1f} us by {k4_by}, "
                  f"{k4_b / k4_ms:.1%}), plain {k4_pms * 1e3:.1f} us", flush=True)
    for key, rows in per_call.items():
        stats[key] = {"ms": statistics.mean(r[0] for r in rows),
                      "plain_ms": statistics.mean(r[1] for r in rows),
                      "bound_ms": statistics.mean(r[2] for r in rows), "bound_by": rows[0][3]}
        total = sum(r[0] for r in rows)
        print(f"[encode] {key} share of one encode: {len(rows)} calls, {total:.2f} ms of "
              f"{enc_ms:.2f} ms", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        enc_a(variables, waves)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    print(f"[profile] one encode under torch.profiler: wall {pwall * 1e3:.2f} ms", flush=True)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15), flush=True)
    return launches, stats


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a CUDA card",
              file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import zs_aac_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    phase_build()
    worst = phase_k1_vs_plain()
    phase_fixture_captions()
    launches, k1 = phase_full_width()
    k2_err = phase_k2_vs_plain()
    window_err = phase_window_vs_plain()
    phase_fixture_bank()
    enc_launches, enc = phase_encode_full_width()

    kernels = [{
        "name": "decode_attn_q8",
        "route": "cuda",
        "source": "zs_aac_tpu_torch/csrc/decode_attn.cu",
        "replaces": "zs_aac_tpu/ops/decode_attn.py:51",
        "launches": launches,
        "max_abs_err": worst["bfloat16"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]
    for key, name, source, replaces, err in (
            ("K2", "log_mel", "zs_aac_tpu_torch/csrc/logmel.cu",
             "zs_aac_tpu/ops/logmel.py:192", k2_err),
            ("K3", "fused_swin_block", "zs_aac_tpu_torch/csrc/window_attn.cu",
             "zs_aac_tpu/ops/window_attn.py:253", window_err["k3"]),
            ("K4", "fused_swin_block (stage-4 shape, K4's function)",
             "zs_aac_tpu_torch/csrc/window_attn.cu", "zs_aac_tpu/ops/window_attn.py:360",
             window_err["k4"]),
            ("K5", "fused_window_attention", "zs_aac_tpu_torch/csrc/window_attn.cu",
             "zs_aac_tpu/ops/window_attn.py:77", window_err["k5"])):
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": enc_launches.get(key, 0), "max_abs_err": err,
                        **enc[key], "library_ms": None})
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
