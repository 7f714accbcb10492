#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``zs_aac_tpu_torch``) on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py`` (one card; the
kernels build with nvcc at first use, one nvcc per source, in parallel). It
fails, printing no result, where CUDA is not available. Phases, each of
which must pass:

1. build every kernel: K1 (``csrc/decode_attn.cu``), K2 (``csrc/logmel.cu``),
   K3/K5/K7 (``csrc/window_attn.cu``) and K6/K8/K9 (``csrc/swin_train.cu``),
   with each nvcc's time;
2. hold K1 against its plain PyTorch version at the main path's shapes
   (B=256, H=12, d=64, T=77) and at edge shapes (B=1, d=16; d=24; d=12, 6
   and 5, the narrower loads), fp32 and bf16, then at every index 10..76 in
   turn on one cache (d=64 and 24), the cache rows and scales bytewise equal
   after each step;
3. exact captions on learned weights: the port's ``predict_prompt`` on the
   committed tiny captioner (greedy and ``--q8``, beam ``--isbeam`` and
   ``--isbeam --q8``) reproduces the captions the JAX package recorded, K1
   launched in the two ``--q8`` modes only;
4. the decode half at full width: CLAP embedding -> MLP mapper
   1024->3840->7680 -> GPT-2 124M (seeded random weights), B=256, Lp=10, 67
   greedy steps, bf16 activations, w8a8 weights + int8 KV cache, every
   attention through K1 (launch count checked). Kernel and plain attention
   are teacher-forced on one token stream and their logits compared;
   captions/s and K1's time per call beside its byte bound are measured
   with CUDA events (K1 launched from Python, the kernels line's ``ms``, and
   as a CUDA graph of the same launches, the kernel's own time, its
   ``graph_ms``), and a ``torch.profiler`` table of one decode printed;
5. K2 (log-mel) against its plain version at B=64 x 10 s and at edge shapes
   (B=1, odd T, T near n_fft and T = 513, silence, pure tones), also at the
   16 kHz config (n_fft 512, 40 mels) and with 16 mels; each launch through
   the instantiation ``logmel_plan`` names, all of these the frame-run
   kernel (``log_mel.fast_launches``), and the first kernel at n_fft 128 and
   4096;
6. K3 (whole Swin block) against its plain version at HTSAT's three stage
   shapes, shifted and unshifted, fp32 (the FMA kernel) and bf16 (the
   tensor-core kernels; which of the two ran is checked), and at the stage-4
   shape in bf16 (the function of the TPU's streamed kernel K4); K5 (window
   attention) at the stage-4 shape and a shifted stage-1 shape; a refused
   launch (head dim 96) must raise;
7. exact embeddings on learned weights: the port's ``load_ase_encoders`` +
   ``extract_audio_text_bank`` on the committed tiny ASE (fp32) reproduce
   the JAX-recorded audio and text embeddings, with K2, K3 and K5 launched;
8. the encode half at full width (``configs/extract_data.yaml``'s geometry,
   seeded random weights, bf16): B=64 ten-second waves -> K2 -> HTSAT
   (K3 in stages 1-3, K5 + PyTorch MLP in stage 4) -> projection ->
   [64, 1024] L2-normalized embeddings. Launch counts per encode are checked
   (K2 1 through the frame-run kernel, K3 10, K5 2, all 12 through the
   tensor-core kernels), the embeddings are compared row by row with the
   all-plain path's (cosine), clips/s and BERT-base texts/s are measured
   with CUDA events, each kernel's time per call is set beside its bound
   (K2's beside ``torch.stft``'s too, the STFT part of its function alone),
   and a ``torch.profiler`` table of one encode is printed with the device's
   busy time and K2's share of it (0 where the profiler dropped K2: see
   ``profiled``);
9. the train kernels against their plain versions at B=64: K7 (train
   forward), K8 (MLP backward) and K9 (attention + LN1 backward) at the
   stage 1-3 shapes, shift 0 and 4, bf16 and fp32; K6 (window-attention
   backward) at the stage-4 shape in bf16 (and at 16x16x768 with shift 4)
   and a shifted stage-1 shape in bf16 and fp32; drop-path scales holding 0
   and 1/keep (a dropped row passes its cotangent through exactly). K8 and
   K9 in bf16 must take the tensor-core kernels and in fp32 the FMA ones,
   K6 the tensor-core kernels at C=768 in bf16 and the FMA ones otherwise,
   and each give bitwise the same result twice; the tensor-core
   weight-gradient product alone is held to ``A^T B`` on a token count that
   no chunk divides;
10. gradients through K3 and K5 (their wrappers are autograd Functions)
    equal the plain versions' autograd;
11. the committed tiny-ASE train run (3 Adam steps, fp32) on the card's
    dispatch reproduces the JAX-recorded losses, parameter checksums and
    batch statistics, with K2 1 and K5/K6/K7/K8/K9 2 launches per step;
12. the drivers: ``pretrain.run`` for 2 steps and a ``finetune.run`` warm
    start on a toy corpus;
13. a full-width training step (extract_data.yaml's HTSAT + BERT-base,
    embed 1024, bf16 over fp32 parameters, B=64 ten-second waves, Adam lr
    5e-5 cosine, clip 2, spec augmentation and drop path 0.1): one warm-up
    and 5 timed steps on one batch, launch counts per step checked (K2 1
    through the frame-run kernel, K7/K8/K9 10 each, K5/K6 2 each; K7's and
    K5's 12 forward launches, the 20 of K8 and K9, K6's 2 and the 44
    weight-gradient products of K6, K8 and K9 all through the tensor-core
    kernels), the loss on the batch with fixed random
    draws lower after the steps, per-leaf gradient cosine >= 0.99 and norm
    ratio within 5% of 1 against the all-plain path, samples/s, peak memory, each train kernel's time per
    call beside its bound and a ``torch.profiler`` table of one step (with
    K2's share of its device time, as in phase 8);
14. beam search at full width: the decode half of phase 4 with B=64 clips x
    K=3 beams (the driver's ``--beam_size``), Lp=10, 67 steps, bf16, w8a8 +
    int8 KV cache, every attention through K1 at B*K rows (launches checked:
    n_layer x the steps run). Token ids in range, scores finite, each clip's
    best beam (``argmax(scores)``, the driver's pick) its first; teacher-forced
    on the decode's own tokens and beam sources, K1's logits against the
    plain attention's within ``LOGIT_TOL`` (phase 4's flip rule); captions/s
    (median of three walls), the best beam's free-running agreement with the
    plain path, a ``torch.profiler`` table of one decode's kernels (read off
    the profiler's records: ``profiled_kernels``) with the device's busy
    time, idle share and K1's share, and ``reorder_beam_cache``'s time per
    decode (CUDA events over the decode's positions) and its share.

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
# summation order, so fp32 outputs agree to ~1e-5 of |o| <= 8; in bf16 the
# fp32 sum of p v8 rounds to bf16, and where the two orders straddle a
# rounding boundary the outputs land one bf16 step apart: the spacing of bf16
# numbers at the largest |o| (0.03125 for |o| in [4, 8), which the decode's
# shapes reach: max|o| 6.4). The cache row and scales come from identical
# ops: bytewise equal. fp32: absolute; bf16: relative to the power of two at
# or below the plain version's largest |o| (2^-7 of it is one bf16 step there).
K1_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}


def k1_tol(name, ref):
    if name == "float32":
        return K1_TOL[name]
    return K1_TOL[name] * 2.0 ** math.floor(math.log2(ref.float().abs().max().item()))
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


def graph_ms(fn, reps, replays=3):
    """Mean ms of ``fn(r)`` for r = 0..reps-1 captured once in a CUDA graph
    and replayed: the device's time without the host's launch overhead."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for r in range(reps):
            fn(r)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def profiled(fn):
    """``fn()`` once under torch.profiler: (its result, the host's wall ms,
    the device's busy ms, the key averages). A token kernel opens the window
    (its ~1 us may count): after an earlier large profile the profiler can
    drop a window's first kernel. It does not keep K2 here: after phase 4's
    decode profile the encode's and the step's profiles hold no K2
    (``k2_profiled_ms`` 0 on the H100), so their device time leaves K2 out;
    ``examples/profile_paths.py`` profiles both in a process of their own,
    where K2 is kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # the kernels' own events (CPU-side ops also carry the device time of
    # the kernels they enclose)
    dev_ms = sum(e.self_device_time_total for e in events
                 if e.device_type != torch.autograd.DeviceType.CPU) / 1e3
    return out, wall, dev_ms, events


def profiled_kernels(fn):
    """``fn()`` once under torch.profiler, device activity only: (the host's
    wall ms, {kernel name: [device ms, calls]}). The kernels are read off the
    profiler's own records: ``key_averages`` over a 67-step beam decode's
    ~50,000 kernels takes 20-40 s on the card's host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CPU:
            k = kernels.setdefault(e.name(), [0.0, 0])
            k[0] += e.duration_ns() / 1e6
            k[1] += 1
    return wall, kernels


def k2_profiled_ms(events):
    """K2's device ms among profiled ``events``: either instantiation, or
    ``log_mel_kernel``, its one kernel in checkouts before the frame-run
    kernel (``examples/profile_paths.py --root`` profiles those too)."""
    names = ("frames::kernel<", "radix2::kernel", "::log_mel_kernel(")
    return sum(e.self_device_time_total for e in events
               if any(n in e.key for n in names)) / 1e3


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

    names = ["decode_attn", "logmel", "window_attn", "swin_train"]
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
            [(1, 4, 13, 16, i) for i in (0, 6, 12)] + [(8, 2, 13, 24, i) for i in (0, 12)] + \
            [(4, 3, 13, d, i) for d in (12, 6, 5) for i in (0, 12)]   # 4-, 2-, 1-byte loads
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for B, H, T, d, index in cases:
            a = k1_inputs(B, H, T, d, dtype, g)
            b = [x.clone() for x in a]
            o = decode_attn_q8(*a, index)
            o_ref = decode_attn_q8_plain(*b, index)
            torch.cuda.synchronize()
            err, tol = (o.float() - o_ref.float()).abs().max().item(), k1_tol(name, o_ref)
            same = all(torch.equal(x, y) for x, y in zip(a[3:], b[3:]))
            print(f"[k1] {name} B={B} H={H} T={T} d={d} index={index}: "
                  f"max|o-o_plain|={err:.3g} (tol {tol:.3g}), cache bytes equal={same}",
                  flush=True)
            check(err <= tol, f"K1 disagrees with its plain version ({err} > {tol})")
            check(same, "K1's cache row or scales differ from the plain version's")
            if B == 256:
                worst[name] = max(worst.get(name, 0.0), err)
    # the decode's order: one cache, every index 10..76 in turn with new
    # q/k/v, the kernel's copy and the plain version's compared after each
    for d in (64, 24):
        a = k1_inputs(256, 12, 77, d, torch.bfloat16, g)
        b = [x.clone() for x in a[3:]]
        err, n_same, n_over = 0.0, 0, 0
        for index in range(10, 77):
            qkv = [torch.randn(256, 12, d, generator=g, device="cuda").bfloat16() * s
                   for s in (1, 2, 1)]
            o = decode_attn_q8(*qkv, *a[3:], index)
            o_ref = decode_attn_q8_plain(*qkv, *b, index)
            e = (o.float() - o_ref.float()).abs().max().item()
            err, n_over = max(err, e), n_over + (e > k1_tol("bfloat16", o_ref))
            n_same += all(torch.equal(x, y) for x, y in zip(a[3:], b))
        print(f"[k1] bfloat16 B=256 H=12 T=77 d={d}, indices 10..76 in turn on one cache: "
              f"caches bytewise equal after {n_same} of 67 steps, max|o-o_plain|={err:.3g}, "
              f"over one bf16 step at the largest |o| in {n_over} of 67 steps", flush=True)
        check(n_same == 67, "K1's cache rows or scales differ from the plain version's")
        check(n_over == 0, "K1 disagrees with its plain version")
        if d == 64:
            worst["bfloat16"] = max(worst["bfloat16"], err)
    return worst


def phase_fixture_captions():
    import torch

    from zs_aac_tpu_torch.ops.decode_attn import decode_attn_q8
    from zs_aac_tpu_torch.testdata import stage_tiny_captioner
    from zs_aac_tpu_torch.train.predict_prompt import main as predict

    for mode, flags in (("greedy", []), ("q8", ["--q8"]), ("beam", ["--isbeam"]),
                        ("beam_q8", ["--isbeam", "--q8"])):
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
        check((launches > 0) == mode.endswith("q8"), f"{mode}: unexpected K1 launches {launches}")


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
    # Each index is timed twice: launched from Python, as the decode does (the
    # host's ~20 us a call of checks and ctypes can set that time; the
    # kernels line's "ms", as before), and as a CUDA graph of the same 20
    # launches, the kernel's own time ("graph_ms").
    g = torch.Generator(device="cuda").manual_seed(3)
    bufs = [k1_inputs(B, H, Lp + steps, d, torch.bfloat16, g) for _ in range(4)]
    kms, gms, pms, bms, nbytes = [], [], [], [], []
    for index in range(Lp, Lp + steps):
        decode_attn_q8(*bufs[0], index)
        kms.append(timed_ms(lambda r: decode_attn_q8(*bufs[r % 4], index), 20))
        gms.append(graph_ms(lambda r: decode_attn_q8(*bufs[r % 4], index), 20))
        pms.append(timed_ms(lambda r: decode_attn_q8_plain(*bufs[r % 4], index), 4))
        bm, nb = k1_bound(B, H, d, index, 2)
        bms.append(bm)
        nbytes.append(nb)
    k1 = {"ms": statistics.mean(kms), "graph_ms": statistics.mean(gms),
          "plain_ms": statistics.mean(pms), "bound_ms": statistics.mean(bms)}
    print(f"[full] K1 per call, mean over index {Lp}..{Lp + steps - 1} at B={B} bf16: "
          f"{k1['ms'] * 1e3:.2f} us launched from Python, {k1['graph_ms'] * 1e3:.2f} us in a "
          f"CUDA graph (bound {k1['bound_ms'] * 1e3:.2f} us, "
          f"{statistics.mean(nbytes) / 1e6:.2f} MB at {H100_BYTES_PER_S / 1e12} TB/s; "
          f"{k1['bound_ms'] / k1['ms']:.1%} of bound launched, "
          f"{k1['bound_ms'] / k1['graph_ms']:.1%} in the graph), plain "
          f"{k1['plain_ms'] * 1e3:.2f} us; first/last index {kms[0] * 1e3:.2f}/"
          f"{kms[-1] * 1e3:.2f} us from Python, {gms[0] * 1e3:.2f}/{gms[-1] * 1e3:.2f} us in "
          f"the graph", flush=True)
    print(f"[full] K1's kernel time in one decode: {launches} x {k1['graph_ms']:.4f} ms = "
          f"{launches * k1['graph_ms']:.2f} ms of {wall * 1e3:.2f} ms", flush=True)

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


# -- beam search ----------------------------------------------------------------


def beam_steps_run(lens, entry_length):
    """Steps the beam loop ran: it leaves at the first check (every
    CHECK_EVERY steps) after the step where the last beam stopped, i.e. the
    longest beam's length - 1."""
    from zs_aac_tpu_torch.decoding.greedy import CHECK_EVERY

    t_all = int(lens.max()) - 1
    return min(entry_length - 1, math.ceil(t_all / CHECK_EVERY) * CHECK_EVERY)


def phase_beam_full_width():
    import torch

    from zs_aac_tpu_torch.decoding import beam
    from zs_aac_tpu_torch.models.caption import (CaptionConfig, caption_embeddings,
                                                 init_caption_model)
    from zs_aac_tpu_torch.models.convert import cast_floating
    from zs_aac_tpu_torch.models.gpt2 import (GPT2Config, expand_beam_cache, gpt2_embed,
                                              gpt2_prefill_q8, gpt2_step_q8, init_kv_cache_q8,
                                              quantize_gpt2_int8, reorder_beam_cache)
    from zs_aac_tpu_torch.ops.decode_attn import decode_attn_q8, decode_attn_q8_plain

    B, K, Lp, steps = 64, 3, 10, 67
    cfg = CaptionConfig(prefix_length=Lp, prefix_size=1024, gpt2=GPT2Config())
    gcfg = cfg.gpt2
    with torch.no_grad():
        params = init_caption_model(cfg, seed=0, device="cuda")
        qp = quantize_gpt2_int8(cast_floating(params["gpt2"], torch.bfloat16), "w8a8")
        g = torch.Generator(device="cuda").manual_seed(4)
        prefix = torch.randn(B, cfg.prefix_size, generator=g, device="cuda")
        emb = caption_embeddings(params, cfg, prefix).to(torch.bfloat16)
        del params

    def decode(attention=decode_attn_q8):
        return beam.beam_search_batched_q8(qp, gcfg, emb, K, steps, 13, attention=attention)

    decode()                                    # warm-up
    torch.cuda.synchronize()
    # the main path, counted; each step's selection kept for the teacher forcing
    picks, select = [], beam._beam_select
    beam._beam_select = lambda *a: picks.append(select(*a)) or picks[-1]
    try:
        decode_attn_q8.launches = 0
        t0 = time.perf_counter()
        toks, lens, scores = decode()
        torch.cuda.synchronize()
        walls = [time.perf_counter() - t0]
        launches = decode_attn_q8.launches
    finally:
        beam._beam_select = select
    steps_run = beam_steps_run(lens, steps)
    print(f"[beam] w8a8+q8 beam B={B} K={K} Lp={Lp}: lengths min/max {int(lens.min())}/"
          f"{int(lens.max())}, steps run {steps_run}, K1 launches {launches} "
          f"(expected {gcfg.n_layer} x {steps_run}) at {B * K} rows", flush=True)
    check(launches == gcfg.n_layer * steps_run, "beam: K1 launch count off the main path's")
    check(len(picks) == steps_run, "beam: selections off the steps run")
    check(tuple(toks.shape) == (B, K, steps) and tuple(scores.shape) == (B, K),
          f"beam outputs {tuple(toks.shape)} {tuple(scores.shape)}")
    check(bool(((toks >= 0) & (toks < gcfg.vocab_size)).all()), "beam: token ids out of range")
    check(bool(torch.isfinite(scores).all()), "beam: scores not finite")
    best = scores.argmax(dim=1)
    first_best = torch.isclose(scores[:, 0], scores.max(dim=1).values, rtol=1e-6, atol=0)
    print(f"[beam] best beam (argmax of scores) is the first in {int((best == 0).sum())} of "
          f"{B} clips, within an fp32 rounding of it in {int(first_best.sum())}", flush=True)
    check(bool(first_best.all()), "beam: a clip's best beam is not its first")
    for _ in range(2):
        t0 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print(f"[beam] decode walls {[round(w * 1e3, 2) for w in walls]} ms -> "
          f"{B / wall:.1f} captions/s (median; {steps_run} steps, {B * K} beam rows)",
          flush=True)

    # free-running agreement of the best beams with the plain attention (information)
    rows = torch.arange(B, device="cuda")
    toks_p, _, scores_p = decode(attention=decode_attn_q8_plain)
    best_p = scores_p.argmax(dim=1)
    agree = (toks_p[rows, best_p] == toks[rows, best]).float().mean().item()
    same = int((toks_p[rows, best_p] == toks[rows, best]).all(dim=1).sum())
    print(f"[beam] free-running best-beam token agreement, K1 vs plain: {agree:.4f} "
          f"({same} of {B} captions identical)", flush=True)

    # teacher-forced on the decode's own tokens and beam sources: K1 vs plain
    with torch.no_grad():
        caches = []
        for _ in range(2):
            c = init_kv_cache_q8(gcfg, B, Lp + steps)
            logits, c = gpt2_prefill_q8(qp, gcfg, emb, c)
            caches.append(expand_beam_cache(c, K))
        _, cur = beam._topk_argmax(torch.log_softmax(logits[:, -1].float(), dim=-1), K)
        dmax, flip_margin, n_flips, lmax = 0.0, 0.0, 0, 0.0
        for i in range(1, steps_run + 1):
            x = gpt2_embed(qp, cur.reshape(-1))
            lk, _ = gpt2_step_q8(qp, gcfg, x, caches[0], Lp + i - 1)
            lp, _ = gpt2_step_q8(qp, gcfg, x, caches[1], Lp + i - 1,
                                 attention=decode_attn_q8_plain)
            dmax = max(dmax, (lk - lp).abs().max().item())
            lmax = max(lmax, lp.abs().max().item())
            top2 = lp.topk(2, dim=-1).values
            flips = lk.argmax(-1) != lp.argmax(-1)
            if flips.any():
                n_flips += int(flips.sum())
                flip_margin = max(flip_margin, (top2[:, 0] - top2[:, 1])[flips].max().item())
            _, src, cur, _ = picks[i - 1]
            for c in caches:
                reorder_beam_cache(c, src, Lp + i)
    print(f"[beam] teacher-forced logits, K1 vs plain: max|diff| {dmax:.4g} (tol {LOGIT_TOL}; "
          f"max|logit| {lmax:.3g}), argmax flips {n_flips} of {B * K * steps_run}, largest "
          f"top-2 margin at a flip {flip_margin:.4g}", flush=True)
    check(dmax <= LOGIT_TOL, "beam: teacher-forced logits diverge beyond the bf16 tolerance")
    check(n_flips == 0 or flip_margin <= 2 * dmax,
          "beam: an argmax flip at a top-2 margin larger than the logit divergence")
    del caches

    # where one decode spends its device time; K1's share of it
    pwall, kernels = profiled_kernels(decode)
    dev_ms = sum(ms for ms, _ in kernels.values())
    k1_ms = sum(ms for name, (ms, _) in kernels.items() if "decode_attn_q8_kernel" in name)
    print(f"[beam] one decode under torch.profiler: wall {pwall:.2f} ms, device busy "
          f"{dev_ms:.2f} ms, idle {1 - dev_ms / pwall:.1%}; K1 {k1_ms:.2f} ms "
          f"({k1_ms / dev_ms:.1%} of the device time)", flush=True)
    print(f"{'device ms':>10} {'share':>6} {'calls':>6} {'us/call':>8}  kernel", flush=True)
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"{ms:10.2f} {ms / dev_ms:6.1%} {n:6d} {ms / n * 1e3:8.2f}  {name[:100]}",
              flush=True)

    # the cache reorder alone at the decode's positions, a full-size beam cache
    cache = expand_beam_cache(init_kv_cache_q8(gcfg, B, Lp + steps), K)
    srcs = [torch.randint(0, K, (B, K), generator=g, device="cuda") for _ in range(steps_run)]
    reorder_beam_cache(cache, srcs[0], Lp + 1)
    reorder_ms = timed_ms(lambda r: reorder_beam_cache(cache, srcs[r], Lp + 1 + r),
                          steps_run) * steps_run
    nbytes = sum(2 * 2 * gcfg.n_layer * B * K * gcfg.n_head * (Lp + i) * (gcfg.n_embd //
                                                                          gcfg.n_head + 4)
                 for i in range(1, steps_run + 1))
    print(f"[beam] reorder_beam_cache: {reorder_ms:.2f} ms per decode over {steps_run} steps "
          f"({reorder_ms / dev_ms:.1%} of the profiled device time; "
          f"{nbytes / 1e9:.2f} GB read and written, "
          f"{nbytes / (reorder_ms * 1e-3) / 1e12:.2f} TB/s)", flush=True)
    return launches

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


K2_CONFIGS = {"default": {}, "16k": dict(sr=16000, n_fft=512, hop_length=160, n_mels=40,
                                          f_min=0.0, f_max=8000.0),
              "16mels": dict(n_mels=16), "n_fft 128": dict(n_fft=128, hop_length=32),
              "n_fft 4096": dict(n_fft=4096, hop_length=1024)}


def phase_k2_vs_plain():
    import torch

    from zs_aac_tpu_torch.ops.logmel import LogMelConfig, log_mel, log_mel_plain, logmel_plan

    g = torch.Generator(device="cuda").manual_seed(4)
    worst = 0.0
    cases = [("default", B, T) for B, T in [(64, 320000), (1, 320000), (1, 16001), (3, 7777),
                                            (1, 1025), (1, 1000), (1, 513)]]
    cases += [(name, B, T) for name in ("16k", "16mels") for B, T in [(64, 320000), (2, 16001),
                                                                      (1, 513)]]
    cases += [("n_fft 128", 2, 16001), ("n_fft 4096", 2, 16001)]
    for name, B, T in cases:
        cfg = LogMelConfig(**K2_CONFIGS[name])
        kind = logmel_plan(cfg, B, T).kernel
        check(kind == ("radix2" if name.startswith("n_fft") else "frames"),
              f"K2 {name} B={B} T={T}: the plan names the {kind} kernel")
        w = torch.randn(B, T, generator=g, device="cuda") * 0.1
        n, fast = log_mel.launches, log_mel.fast_launches
        err = (log_mel(w, cfg) - log_mel_plain(w, cfg)).abs().max().item()
        print(f"[k2] {name} noise B={B} T={T}, {kind} kernel: max|dB - dB_plain| = {err:.3g} "
              f"(tol {K2_TOL})", flush=True)
        check(err <= K2_TOL, f"K2 disagrees with its plain version ({err} dB)")
        check((log_mel.launches - n, log_mel.fast_launches - fast) == (1, int(kind == "frames")),
              f"K2 {name} B={B} T={T}: the launch missed the {kind} kernel")
        if name == "default" and B == 64:
            worst = err
        silence = torch.zeros(2, T, device="cuda")
        check(bool((log_mel(silence, cfg) == -100.0).all()),
              f"K2 {name}: silence is not -100 dB everywhere")
    cfg = LogMelConfig()
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
    for fn in (fused_swin_block, fused_window_attention):
        fn.launches = fn.tc_launches = 0
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
    counts = [(fn.launches, fn.tc_launches) for fn in (fused_swin_block, fused_window_attention)]
    print(f"[k3/k5] launches (all, tensor-core): K3 {counts[0]}, K5 {counts[1]} (bf16 at "
          "HTSAT's shapes takes the tensor-core kernels, fp32 the FMA kernel)", flush=True)
    check(counts == [(13, 7), (4, 2)], f"K3/K5 instantiations off the plan: {counts}")
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

    from zs_aac_tpu_torch.models.ase import ASE, init_ase
    from zs_aac_tpu_torch.models.convert import cast_floating
    from zs_aac_tpu_torch.ops.logmel import LogMelConfig, log_mel, log_mel_plain
    from zs_aac_tpu_torch.ops.window_attn import (build_window_bias, fused_swin_block,
                                                  fused_window_attention, swin_block_plain,
                                                  window_attention_plain)
    from zs_aac_tpu_torch.train.pretrain import build_ase_from_config
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
        fn.launches = fn.tc_launches = 0
    log_mel.fast_launches = 0
    emb = enc_a(variables, waves)               # the main path, counted
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    tc = {k: kernels[k].tc_launches for k in ("K3", "K5")}
    print(f"[encode] B={B} 10 s clips, bf16, seeded weights: embeddings "
          f"{tuple(emb.shape)} {emb.dtype}; launches per encode {launches} "
          f"(expected K2 1, K3 10, K5 2), through the tensor-core kernels {tc}, K2 through "
          f"the frame-run kernel {log_mel.fast_launches}", flush=True)
    check(launches == {"K2": 1, "K3": 10, "K5": 2}, "encode launch counts off the main path's")
    check(tc == {"K3": 10, "K5": 2}, "an encode launch of K3 or K5 missed the tensor-core kernels")
    check(log_mel.fast_launches == 1, "the encode's K2 launch missed the frame-run kernel")
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
    hann = torch.hann_window(mel_cfg.n_fft, periodic=True, device="cuda")
    stft = lambda r: torch.stft(waves, mel_cfg.n_fft, mel_cfg.hop_length, window=hann,
                                center=True, pad_mode="reflect", return_complex=True)
    stft(0)
    stft_ms = timed_ms(stft, 10)
    stats["K2"] = {"ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_b, "bound_by": k2_by,
                   "stft_ms": stft_ms}
    print(f"[encode] K2 B={B} T={T}: {k2_ms * 1e3:.1f} us (bound {k2_b * 1e3:.1f} us by {k2_by}, "
          f"{k2_b / k2_ms:.1%}), plain {k2_plain * 1e3:.1f} us, torch.stft (the STFT part "
          f"alone) {stft_ms * 1e3:.1f} us", flush=True)
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

    _, pwall, dev_ms, events = profiled(lambda: enc_a(variables, waves))
    print(f"[profile] one encode under torch.profiler: wall {pwall:.2f} ms, device time "
          f"{dev_ms:.2f} ms (device idle {1 - dev_ms / pwall:.1%} of the wall), K2 "
          f"{k2_profiled_ms(events):.3f} ms of it", flush=True)
    print(events.table(sort_by="cuda_time_total", row_limit=15), flush=True)
    return launches, stats


# -- the training half: HTSAT-BERT contrastive training ----------------------------

# configs/pretrain.yaml's optimizer and training switches on the encoder
# geometry of configs/extract_data.yaml (HTSAT takes at most 1024 frames, so
# clips are 10 s; the yaml's max_length of 30 would not fit), bf16 compute.
TRAIN_CONFIG = {
    **EXTRACT_CONFIG,
    "training": {"spec_augmentation": True, "epochs": 15, "clip_grad": 2, "warmup_epochs": 2},
    "optim_args": {"lr": 5e-5, "scheduler": "cosine", "optimizer_name": "adam",
                   "betas": [0.9, 0.999], "eps": 1e-8, "momentum": 0.9, "weight_decay": 0.0},
    "audio_encoder_args": {"type": "transformer", "model": "HTSAT", "pretrained": False,
                           "freeze": False},
    "text_encoder_args": {"type": "bert-base-uncased", "freeze": False},
}
KEEP = 0.9   # drop-path keep probability of the deepest block (rate 0.1)
# The tiny-ASE train fixture on the card (fp32, TF32 off) against the
# JAX-recorded run: summation order only, which Adam's per-element
# normalization carries into every update (~1e-5 relative on the CPU).
TRAIN_FIXTURE_TOL = {"loss": 1e-4, "params": 1e-4, "batch_stats": 1e-5}
# Full-width bf16 train step, kernel path vs all-plain path: per-leaf cosine
# of the gradients. The paths round to bf16 at different points (the plain
# MLPs round each matmul output and then its bias add), so the gradients
# carry different bf16 noise; 0.99 is far above what a wrong index, mask or
# shift leaves (~0 for unrelated gradients).
GRAD_COSINE_MIN = 0.99
# A cosine cannot see a leaf's gradient off by a constant factor (a keep
# scale applied twice, a partial sum added twice), so each leaf's norm ratio
# |g_kernel| / |g_plain| is held within 5% of 1 as well: rounding noise of
# many elements is nearly orthogonal to the gradient and moves the ratio by
# about half its squared relative size (< 2% at cosine >= 0.99), and the
# smallest such fault, a keep scale of 1/0.9 applied twice, moves it by 11%.
# A one-element leaf (the temperature) has no direction: its cosine is its
# sign and its norm ratio its whole relative error, which for the
# temperature, a difference of near-equal sums over the batch, is rounding
# (tens of percent in bf16); it is held by its sign only.
GRAD_NORM_TOL = 0.05
# Leaves whose bf16 plain gradient is mostly rounding residue (relative
# distance from the plain path evaluated in fp32 above this) are left out of
# both gates: BERT's key biases, whose exact gradient is 0 (a softmax does
# not see a constant added to every score of a query), and its deepest
# query/key weights, whose gradient through near-uniform attention with
# seeded weights is as small.
GRAD_NOISE_MAX = 0.5


def train_tol(want, want32=None):
    """Kernel vs plain, per output relative to its largest entry. fp32:
    summation order only, 1e-4 of the largest entry. bf16: an fp32
    accumulator summed in another order can flip one bf16 rounding of an
    intermediate (q/k/v, do, ds, dh1, ...), and a flipped score moves a
    softmax row; the kernel is held within twice the plain bf16 version's own
    distance from the plain version evaluated in fp32 on the same inputs
    (``want32``: the size of bf16 rounding noise for this output), plus
    2**-8 of the largest entry."""
    scale = want.float().abs().max().item()
    if want32 is None:
        return 1e-4 * scale + 1e-7
    return 2 * (want.float() - want32.float()).abs().max().item() + 2.0 ** -8 * scale


def _f32(tensors):
    return [t.float() if t.is_floating_point() else t for t in tensors]


def _train_case(B, H, C, heads, dtype, g):
    import torch

    x, w, bias = _window_case(B, H, C, heads, 8, dtype, g)
    gout = torch.randn(B, H, H, C, generator=g, device="cuda").to(dtype)
    m1 = torch.tensor([1 / KEEP, 0.0], device="cuda").repeat(B // 2)
    return x, w, bias, gout, m1, m1.flip(0).contiguous()


def _compare(tag, names, outs, wants, refs):
    """Check each kernel output against the plain one; returns the largest
    absolute difference."""
    worst = 0.0
    for name, got, want, ref in zip(names, outs, wants, refs):
        err = (got.float() - want.float()).abs().max().item()
        tol = train_tol(want, ref)
        check(err <= tol, f"{tag} {name}: {err} > {tol}")
        worst = max(worst, err)
    return worst


def train_bound(kind, B, H, C, heads, itemsize):
    """Least time of one K6/K7/K8/K9 call: each input read once and each
    output written once (activations in the working dtype, weights too,
    bias and gradients fp32), against the per-head flops per token: K7 24C^2
    + 4NC (K3's), K8 40C^2 (fc1 recomputed, dgelu, dfc1/dfc2 weights, dLN2
    input), K9 and K6 22C^2 + 12NC (qkv/proj recomputed, do, dq/dk/dv, dx,
    dWqkv, dWproj)."""
    tokens, N = B * H * H, 64
    nwin_bias = (H // 8) ** 2 * heads * N * N * 4
    act = tokens * C * itemsize
    if kind == "K7":
        flops = 24 * C * C + 4 * N * C
        nbytes = 3 * act + 12 * C * C * itemsize + nwin_bias
    elif kind == "K8":
        flops = 40 * C * C
        nbytes = 3 * act + (8 * C * C + 7 * C) * itemsize + (8 * C * C + 7 * C) * 4
    else:
        flops = 22 * C * C + 12 * N * C
        nbytes = 3 * act + 4 * C * C * itemsize + 2 * nwin_bias + (4 * C * C + 6 * C) * 4
    peak = H100_BF16_FLOPS if itemsize == 2 else H100_FP32_FLOPS
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, tokens * flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_train_kernels_vs_plain():
    """K7/K8/K9 at the stage 1-3 shapes (B=64, shift 0 and 4) in bf16 and fp32,
    K6 at the stage-4 shape in bf16 and at a shifted stage-1 shape, with
    drop-path scales holding 0 and 1/keep; a dropped row passes its
    cotangent through exactly. K8 and K9 in bf16 must take the tensor-core
    kernels (K8: per-token kernel and both weight products; K9: the
    per-window and dx kernels), in fp32 the FMA ones, and give bitwise the
    same result twice; the tensor-core weight-gradient product alone is held
    to ``A^T B`` in fp32 on a ragged token count."""
    import torch

    from zs_aac_tpu_torch.ops import window_attn as wa

    g = torch.Generator(device="cuda").manual_seed(8)
    worst = {"K6": 0.0, "K7": 0.0, "K8": 0.0, "K9": 0.0}
    cases = [(torch.bfloat16, st, shift) for st in STAGES for shift in (0, 4)]
    cases += [(torch.float32, st, 4) for st in STAGES]
    for dtype, (H, C, heads), shift in cases:
        name = str(dtype).split(".")[1]
        x, w, bias, gout, m1, m2 = _train_case(64, H, C, heads, dtype, g)
        cfg = (8, heads, shift, 1e-6)
        bf16 = dtype == torch.bfloat16
        out = wa.fused_swin_block_train(x, *w, bias, m1, m2, *cfg)
        out_ref, y_ref = wa.swin_block_train_plain(x, *w, bias, m1, m2, *cfg)
        ln2_fc = (w[6], w[7], w[8], w[9], w[10])
        tc_before = wa.mlp_bwd.tc_launches
        k8 = wa.mlp_bwd(y_ref, gout, m2, *ln2_fc, 1e-6)
        check(wa.mlp_bwd.tc_launches - tc_before == int(bf16),
              f"K8 {name} {H}x{H}x{C} took the "
              + ("FMA kernels, not the tensor-core ones" if bf16 else "tensor-core kernels"))
        if shift == 4:
            again = wa.mlp_bwd(y_ref, gout, m2, *ln2_fc, 1e-6)
            check(all(torch.equal(a, b) for a, b in zip(k8, again)),
                  f"K8 {name} {H}x{H}x{C}: two runs on the same inputs differ")
        r8 = wa.mlp_bwd_plain(y_ref, gout, m2, *ln2_fc, 1e-6)
        dy = r8[0]
        tc_before = wa.attn_ln1_bwd.tc_launches
        k9 = wa.attn_ln1_bwd(x, dy, m1, *w[:5], bias, *cfg)
        check(wa.attn_ln1_bwd.tc_launches - tc_before == int(bf16),
              f"K9 {name} {H}x{H}x{C} shift={shift} took the "
              + ("FMA kernels, not the tensor-core ones" if bf16 else "tensor-core kernels"))
        again = wa.attn_ln1_bwd(x, dy, m1, *w[:5], bias, *cfg)
        check(all(torch.equal(a, b) for a, b in zip(k9, again)),
              f"K9 {name} {H}x{H}x{C} shift={shift}: two runs on the same inputs differ")
        r9 = wa.attn_ln1_bwd_plain(x, dy, m1, *w[:5], bias, *cfg)
        if bf16:
            o32 = wa.swin_block_train_plain(*_f32([x] + w), bias, m1, m2, *cfg)[:1]
            p8 = wa.mlp_bwd_plain(*_f32([y_ref, gout]), m2, *_f32(ln2_fc), 1e-6)
            p9 = wa.attn_ln1_bwd_plain(*_f32([x, dy]), m1, *_f32(w[:5]), bias, *cfg)
        else:
            o32, p8, p9 = [None], [None] * 7, [None] * 8
        torch.cuda.synchronize()
        e7 = _compare(f"K7 {name} {H}x{H}x{C} shift={shift}", ["out"], [out], [out_ref], o32)
        e8 = _compare(f"K8 {name} {H}x{H}x{C}",
                      ["dy", "dln2_s", "dln2_b", "dfc1_w", "dfc1_b", "dfc2_w", "dfc2_b"], k8,
                      r8, p8)
        e9 = _compare(f"K9 {name} {H}x{H}x{C} shift={shift}",
                      ["dx", "dln1_s", "dln1_b", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b",
                       "dbias"], k9, r9, p9)
        check(torch.equal(k8[0][0], gout[0]) and torch.equal(k9[0][1], dy[1]),
              "a dropped row did not pass its cotangent through exactly")
        print(f"[train-k] {name} B=64 {H}x{H}x{C} heads={heads} shift={shift}: max|kernel-plain| "
              f"K7 {e7:.3g}, K8 {e8:.3g}, K9 {e9:.3g} (each output within train_tol)", flush=True)
        if bf16:
            worst.update(K7=max(worst["K7"], e7), K8=max(worst["K8"], e8), K9=max(worst["K9"], e9))
    # K6: bf16 at C = 768 (stage 4, and a 16x16 input with the shift) on the
    # tensor cores, bitwise equal run to run; bf16 at C = 96 and fp32 on the
    # FMA kernels
    for dtype, (H, C, heads), shift in ((torch.bfloat16, (8, 768, 32), 0),
                                        (torch.bfloat16, (16, 768, 32), 4),
                                        (torch.bfloat16, (64, 96, 4), 4),
                                        (torch.float32, (64, 96, 4), 4)):
        name = str(dtype).split(".")[1]
        tc = dtype == torch.bfloat16 and C == 768
        x, w, bias, gout, _, _ = _train_case(64, H, C, heads, dtype, g)
        tc_before = wa.window_attention_bwd.tc_launches
        k6 = wa.window_attention_bwd(x, gout, *w[2:6], bias, 8, heads, shift)
        check(wa.window_attention_bwd.tc_launches - tc_before == int(tc),
              f"K6 {name} {H}x{H}x{C} shift={shift} took the "
              + ("FMA kernels, not the tensor-core ones" if tc else "tensor-core kernels"))
        if tc:
            again = wa.window_attention_bwd(x, gout, *w[2:6], bias, 8, heads, shift)
            check(all(torch.equal(a, b) for a, b in zip(k6, again)),
                  f"K6 {name} {H}x{H}x{C} shift={shift}: two runs on the same inputs differ")
        r6 = wa.window_attention_bwd_plain(x, gout, *w[2:6], bias, 8, heads, shift)
        p6 = (wa.window_attention_bwd_plain(*_f32([x, gout] + w[2:6]), bias, 8, heads, shift)
              if dtype == torch.bfloat16 else [None] * 6)
        torch.cuda.synchronize()
        e6 = _compare(f"K6 {name} {H}x{H}x{C} shift={shift}",
                      ["dx", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b", "dbias"], k6, r6, p6)
        print(f"[train-k] K6 {name} B=64 {H}x{H}x{C} heads={heads} shift={shift} "
              f"({'tensor cores, two runs bitwise equal' if tc else 'FMA kernels'}): "
              f"max|kernel-plain| {e6:.3g} (each output within train_tol)", flush=True)
        if tc:
            worst["K6"] = max(worst["K6"], e6)
    # the tensor-core weight-gradient product alone: 8200 tokens are no
    # multiple of the 32-token step, nor of a chunk; fp32 sums of exact bf16
    # products in another order, 1e-4 of the largest entry
    for M, Ncol in ((96, 384), (384, 96), (192, 576), (768, 768)):
        n_tok = 8200
        A = torch.randn(n_tok, M, generator=g, device="cuda").bfloat16()
        Bm = torch.randn(n_tok, Ncol, generator=g, device="cuda").bfloat16()
        got, tc = wa._wgrad(wa._train_lib(), "chip_smoke", A, M, Bm, Ncol, n_tok, M, Ncol)
        want = A.float().t() @ Bm.float()
        err, tol = (got - want).abs().max().item(), train_tol(want)
        n_chunks = wa.wgrad_plan(torch.bfloat16, n_tok, M, Ncol)[1]
        check(tc, f"the [{n_tok}, {M}]^T [{n_tok}, {Ncol}] product missed the tensor-core kernel")
        check(err <= tol, f"weight-gradient product {M}x{Ncol}: {err} > {tol}")
        print(f"[train-k] weight-gradient product [{n_tok}, {M}]^T [{n_tok}, {Ncol}] bf16, "
              f"{n_chunks} chunks, tensor cores: max|kernel - A^T B| {err:.3g} (tol {tol:.3g})",
              flush=True)
    return worst


def phase_grad_repair():
    """Gradients through K2 (the VJP of the plain log-mel), K3 (the autograd
    of the plain block) and K5 (K6) on the card equal those of the plain
    versions' autograd."""
    import torch

    from zs_aac_tpu_torch.ops import window_attn as wa
    from zs_aac_tpu_torch.ops.logmel import LogMelConfig, log_mel, log_mel_plain

    g = torch.Generator(device="cuda").manual_seed(9)
    # d(wave) through K2, B=4 ten-second clips, fp32: the backward runs the
    # same plain ops as the plain version's autograd on the same wave, so the
    # two agree up to the libraries' summation order: 1e-6 of the largest entry
    mel_cfg = LogMelConfig.from_dict(TRAIN_CONFIG["audio_args"])
    wave = torch.randn(4, 10 * 32000, generator=g, device="cuda") * 0.1
    leaf, plain_leaf = wave.clone().requires_grad_(), wave.clone().requires_grad_()
    n = log_mel.launches
    out = log_mel(leaf, mel_cfg)
    cot = torch.randn(out.shape, generator=g, device="cuda")
    got = torch.autograd.grad(out, leaf, cot)[0]
    want = torch.autograd.grad(log_mel_plain(plain_leaf, mel_cfg), plain_leaf, cot)[0]
    torch.cuda.synchronize()
    err, tol = (got - want).abs().max().item(), 1e-6 * want.abs().max().item()
    check(log_mel.launches == n + 1, f"K2 launches {log_mel.launches - n} for one call")
    check(err <= tol, f"K2 d(wave): {err} > {tol}")
    print(f"[repair] fp32 B=4 10 s waves: d(wave) through K2 carried (max|diff| to the plain "
          f"autograd {err:.3g}, tol {tol:.3g})", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        x, w, bias, gout, _, _ = _train_case(8, 32, 192, 8, dtype, g)
        leaves = [t.clone().requires_grad_() for t in [x] + w + [bias]]
        plain = [t.clone().requires_grad_() for t in [x] + w + [bias]]
        cfg = (8, 8, 4)
        got = torch.autograd.grad(wa.fused_swin_block(*leaves, *cfg, 1e-6), leaves, gout)
        want = torch.autograd.grad(wa.swin_block_plain(*plain, *cfg, 1e-6), plain, gout)
        e3 = _compare(f"K3 gradients {name}", [f"d{i}" for i in range(14)], got, want,
                      [None] * 14 if dtype == torch.float32 else want)
        attn = [leaves[0]] + leaves[3:7] + [leaves[13]]
        attn_p = [plain[0]] + plain[3:7] + [plain[13]]
        got = torch.autograd.grad(wa.fused_window_attention(*attn, *cfg), attn, gout)
        want = torch.autograd.grad(wa.window_attention_plain(*attn_p, *cfg), attn_p, gout)
        refs = [None] * 6
        if dtype == torch.bfloat16:
            a32 = [t.detach().float().requires_grad_() for t in attn_p[:-1]] + [attn_p[-1]]
            refs = torch.autograd.grad(wa.window_attention_plain(*a32, *cfg), a32, gout.float())
        e5 = _compare(f"K5/K6 gradients {name}", ["dx", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b",
                                                   "dbias"], got, want, refs)
        print(f"[repair] {name} B=8 32x32x192: gradients through K3 and K5 carried "
              f"(max|diff| to the plain autograd: K3 {e3:.3g}, K5/K6 {e5:.3g})", flush=True)


def phase_fixture_train():
    """The committed tiny-ASE train run (3 steps, fp32, TF32 off) through
    the card's dispatch: K7/K8/K9 in stage 0, K5/K6 in stage 1."""
    import json as _json

    from zs_aac_tpu_torch import testdata
    from zs_aac_tpu_torch.ops.logmel import log_mel
    from zs_aac_tpu_torch.ops import window_attn as wa

    kernels = {"K2": log_mel, "K5": wa.fused_window_attention, "K6": wa.window_attention_bwd,
               "K7": wa.fused_swin_block_train, "K8": wa.mlp_bwd, "K9": wa.attn_ln1_bwd}
    for fn in kernels.values():
        fn.launches = 0
    got = testdata.replay_train_fixture(device="cuda", fused_attn=True, fused_block=[0])
    per_step = {k: fn.launches / testdata.TRAIN_STEPS for k, fn in kernels.items()}
    want = _json.loads((testdata.TINY_ASE_DIR / "train_expected.json").read_text())
    err = testdata.train_fixture_errors(got, want)
    print(f"[fixture-train] tiny ASE, {testdata.TRAIN_STEPS} steps on cuda: losses "
          f"{[round(v, 6) for v in got['losses']]} (JAX {[round(v, 6) for v in want['losses']]}); "
          f"relative errors {err} (tol {TRAIN_FIXTURE_TOL}); launches per step {per_step}",
          flush=True)
    check(all(err[k] <= TRAIN_FIXTURE_TOL[k] for k in err),
          "the train fixture differs from the JAX-recorded run")
    check(per_step == {"K2": 1, "K5": 2, "K6": 2, "K7": 2, "K8": 2, "K9": 2},
          f"fixture launches per step {per_step}")


def _write_corpus(root):
    """A toy retrieval corpus: 8 clips of 2-4 s, 5 captions each, train/val/
    test manifests, a single-caption pretraining manifest and a vocab."""
    import os
    import wave as wavemod

    import numpy as np

    words = ["dog", "rain", "wind", "bird", "car", "park", "sound"]
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words + [".", "a", "the"]
    os.makedirs(f"{root}/Toy/json_files", exist_ok=True)
    os.makedirs(f"{root}/wavs", exist_ok=True)
    rng = np.random.default_rng(0)
    items = []
    for i in range(8):
        dur = float(rng.uniform(2, 4))
        x = (rng.standard_normal(int(dur * 32000)) * 0.05).astype(np.float32)
        path = f"{root}/wavs/a{i}.wav"
        with wavemod.open(path, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(32000)
            f.writeframes((x * 32767).astype("<i2").tobytes())
        item = {"audio": path, "duration": dur, "id": i}
        for c in range(1, 6):
            item[f"caption_{c}"] = " ".join(words[int(k)] for k in rng.integers(0, 7, 5)) + "."
        items.append(item)
    for split in ("train", "val", "test"):
        with open(f"{root}/Toy/json_files/{split}.json", "w") as f:
            json.dump({"num_captions_per_audio": 5, "data": items}, f)
    with open(f"{root}/pretrain.json", "w") as f:
        json.dump({"num_captions_per_audio": 1,
                   "data": [{"audio": it["audio"], "caption": it["caption_1"], "id": i,
                             "duration": it["duration"]} for i, it in enumerate(items)]}, f)
    with open(f"{root}/vocab.txt", "w") as f:
        f.write("\n".join(vocab) + "\n")
    return {
        "exp_name": "smoke", "seed": 20, "embed_size": 16, "temp": 0.07,
        "embed_regularization": True, "json_files": [f"{root}/pretrain.json"],
        "val_datasets": ["Toy"], "data_root": root, "output_dir": f"{root}/outputs",
        "audio_args": {"sr": 32000, "n_fft": 1024, "hop_length": 320, "f_min": 50,
                       "f_max": 14000, "n_mels": 16, "max_length": 5, "mono": True},
        "audio_encoder_args": {"type": "transformer", "model": "HTSAT"},
        "htsat_kwargs": {"spec_size": 128, "patch_size": 4, "patch_stride": 4, "embed_dim": 16,
                         "depths": [2, 2], "num_heads": [2, 4], "window_size": 4, "n_mels": 16,
                         "drop_path_rate": 0.1},
        "data_args": {"batch_size": 4},
        "text_encoder_args": {"type": "bert-tiny-test", "vocab": f"{root}/vocab.txt"},
        "optim_args": {"lr": 5e-4, "scheduler": "cosine", "optimizer_name": "adam",
                       "warmup_epochs": 0},
        "training": {"spec_augmentation": True, "epochs": 1, "clip_grad": 2},
    }


def phase_drivers():
    """``pretrain.run`` for 2 steps and a ``finetune`` warm start on a toy
    corpus, on the card (the train kernels in stage 0, K5/K6 in stage 1)."""
    import os

    import torch

    from zs_aac_tpu_torch.ops import window_attn as wa
    from zs_aac_tpu_torch.train import finetune, pretrain

    # the pretrain driver logs to wandb wherever it imports; keep it offline
    os.environ["WANDB_MODE"] = "disabled"
    with tempfile.TemporaryDirectory() as root:
        config = _write_corpus(root)
        for fn in (wa.fused_swin_block_train, wa.window_attention_bwd):
            fn.launches = 0
        ckpt_dir = pretrain.run(config, device="cuda", max_steps=2, max_val_batches=2)
        best = os.path.join(ckpt_dir, "best_model.ckpt")
        check(os.path.exists(best), "pretrain wrote no best_model.ckpt")
        saved = torch.load(best, map_location="cpu", weights_only=True)
        check(saved["step"] == 2, f"pretrain checkpoint at step {saved['step']}")
        ck2 = finetune.run(config, "Toy", device="cuda", pretrain_path=best, max_steps=1,
                           max_val_batches=2)
        check(os.path.exists(os.path.join(ck2, "best_model.ckpt")), "finetune wrote no checkpoint")
        log = "".join(open(os.path.join(d, f)).read() for d, _, fs in os.walk(root)
                      for f in fs if f == "output.log")
        check("Toy-test[best_model] t2a" in log and "warm start from" in log,
              "the drivers' logs lack the test evaluation or the warm start")
        launches = (wa.fused_swin_block_train.launches, wa.window_attention_bwd.launches)
    print(f"[drivers] pretrain.run 2 steps + finetune.run warm start on cuda: checkpoints "
          f"written, test-set recalls logged; K7/K6 launches {launches}", flush=True)
    check(launches == (6, 6), f"driver launches K7/K6 {launches} (expected 6, 6)")


def _train_batch(B, T, L, g):
    import torch

    t = torch.arange(T, device="cuda") / 32000.0
    freqs = torch.rand(B, 1, generator=g, device="cuda") * 4000 + 100
    wave = (0.3 * torch.sin(2 * math.pi * freqs * t)
            + 0.05 * torch.randn(B, T, generator=g, device="cuda"))
    ids = torch.randint(1000, 30000, (B, L), generator=g, device="cuda")
    ids[:, 0] = 101
    mask = torch.ones(B, L, dtype=torch.int64, device="cuda")
    lens = torch.randint(6, L + 1, (B,), generator=g, device="cuda")
    mask[torch.arange(L, device="cuda")[None] >= lens[:, None]] = 0
    # pairs of rows share an audio id: multi-positive targets
    return {"wave": wave, "input_ids": ids, "attention_mask": mask,
            "idx": torch.arange(B, device="cuda") // 2}


def _leaf_names(tree, prefix=""):
    """Leaf paths of a nested dict, in its key order."""
    out = []
    for k, v in tree.items():
        out += _leaf_names(v, f"{prefix}{k}/") if isinstance(v, dict) else [prefix + k]
    return out


def _loss_grads(ase, variables, spec, batch, seed, grads=True):
    """The train-mode loss with the draws of generator ``seed`` (and the
    gradients of every parameter leaf, or the loss alone as a float)."""
    import torch

    from zs_aac_tpu_torch.models.convert import tree_map
    from zs_aac_tpu_torch.train.optim import tree_leaves

    req = tree_map(lambda t: t.detach().requires_grad_(grads), variables["params"])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.set_grad_enabled(grads):
        loss, _ = ase({"params": req, "batch_stats": variables["batch_stats"]}, spec,
                      batch["input_ids"], batch["attention_mask"], batch["idx"], train=True,
                      generator=gen)
    if not grads:
        return loss.item()
    return loss, torch.autograd.grad(loss, tree_leaves(req), allow_unused=True)


def phase_train_full_width():
    """HTSAT (extract_data.yaml's geometry) + BERT-base, embed 1024, bf16
    compute over fp32 parameters, B=64 ten-second waves and 30 token ids:
    one warm-up and 5 timed train steps on one batch through K2, K7/K8/K9
    (stages 1-3) and K5/K6 (stage 4), Adam lr 5e-5 cosine, clip 2, spec
    augmentation and drop path 0.1 on."""
    import dataclasses

    import torch

    from zs_aac_tpu_torch.models.ase import ASE
    from zs_aac_tpu_torch.ops import window_attn as wa
    from zs_aac_tpu_torch.ops.logmel import LogMelConfig, log_mel, log_mel_plain
    from zs_aac_tpu_torch.train.contrastive import create_ase_state, make_ase_train_step
    from zs_aac_tpu_torch.train.pretrain import build_ase_from_config, build_optimizer

    B, T, L, steps = 64, 10 * 32000, 30, 5
    ase, cfg = build_ase_from_config(TRAIN_CONFIG, device="cuda")
    plain = ASE(dataclasses.replace(cfg, fused_attn=False, fused_block=False))
    check(cfg.fused_attn is True and cfg.fused_block == (0, 1, 2) and cfg.dtype == torch.bfloat16,
          f"train dispatch {cfg.fused_attn}, {cfg.fused_block}, {cfg.dtype}")
    mel_cfg = LogMelConfig.from_dict(TRAIN_CONFIG["audio_args"])
    optimizer = build_optimizer(TRAIN_CONFIG, steps_per_epoch=1)
    state = create_ase_state(0, ase, optimizer, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(10)
    batch = _train_batch(B, T, L, g)
    with torch.no_grad():
        spec_k = log_mel(batch["wave"], mel_cfg)[:, 0]
    # the objective on this batch with one fixed set of random draws (spec
    # augmentation, drop path), before and after the steps: the steps' own
    # losses each see fresh draws
    fixed = lambda st: _loss_grads(ase, {"params": st.params, "batch_stats": st.batch_stats},
                                   spec_k, batch, 78, grads=False)
    before = fixed(state)
    step = make_ase_train_step(ase, optimizer, mel_cfg, device="cuda")
    state, loss0 = step(state, batch, 0)                 # warm-up
    torch.cuda.synchronize()
    kernels = {"K2": log_mel, "K5": wa.fused_window_attention, "K6": wa.window_attention_bwd,
               "K7": wa.fused_swin_block_train, "K8": wa.mlp_bwd, "K9": wa.attn_ln1_bwd}
    for fn in kernels.values():
        fn.launches = fn.tc_launches = 0
    wa._wgrad.tc_launches = 0
    log_mel.fast_launches = 0
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    losses = []
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):                               # the main path, counted
        state, loss = step(state, batch, 0)
        losses.append(loss)
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    step_ms = start.elapsed_time(end) / steps
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = {k: fn.launches / steps for k, fn in kernels.items()}
    tc = {k: kernels[k].tc_launches / steps for k in ("K5", "K6", "K7", "K8", "K9")}
    tc_products = wa._wgrad.tc_launches / steps
    losses = [float(loss0)] + [float(v) for v in losses]
    print(f"[train] B={B} 10 s clips + {L} tokens, bf16, seeded weights: losses {losses}; "
          f"launches per step {per_step} (expected K2 1, K5 2, K6 2, K7 10, K8 10, K9 10), "
          f"launches through the tensor-core kernels {tc}, weight-gradient products on the "
          f"tensor cores {tc_products} (two each of K6, K8 and K9: 44), K2 through the "
          f"frame-run kernel {log_mel.fast_launches / steps}", flush=True)
    check(per_step == {"K2": 1, "K5": 2, "K6": 2, "K7": 10, "K8": 10, "K9": 10},
          "train-step launch counts off the main path's")
    check(tc == {"K5": 2, "K6": 2, "K7": 10, "K8": 10, "K9": 10},
          "a launch of K5, K6, K7, K8 or K9 missed the tensor-core kernels")
    check(tc_products == 44, "a weight-gradient product of K6, K8 or K9 missed the tensor cores")
    check(log_mel.fast_launches / steps == 1, "a step's K2 launch missed the frame-run kernel")
    after = fixed(state)
    print(f"[train] loss on the batch with fixed draws: {before:.6f} before the warm-up, "
          f"{after:.6f} after the 5 timed steps", flush=True)
    check(all(math.isfinite(v) for v in losses + [before, after]), "non-finite train loss")
    check(after < before, "the loss did not fall over the steps")
    print(f"[train] step {step_ms:.2f} ms by CUDA events ({wall * 1e3:.2f} ms host clock) -> "
          f"{B / step_ms * 1e3:.1f} samples/s; peak memory {peak:.2f} GiB", flush=True)

    # gradients: kernel path vs all-plain path, one batch, one generator seed
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    with torch.no_grad():
        spec_p = log_mel_plain(batch["wave"], mel_cfg)[:, 0]
    lk, gk = _loss_grads(ase, variables, spec_k, batch, 77)
    lp, gp = _loss_grads(plain, variables, spec_p, batch, 77)
    plain32 = ASE(dataclasses.replace(cfg, fused_attn=False, fused_block=False,
                                      dtype=torch.float32))
    _, g32 = _loss_grads(plain32, variables, spec_p, batch, 77)
    named, noisy = [], []
    for name, a, b, c in zip(_leaf_names(variables["params"]), gk, gp, g32):
        if a is None or b is None:
            continue
        a, b, c = a.float().reshape(-1), b.float().reshape(-1), c.float().reshape(-1)
        noise = (b - c).norm().item() / max(c.norm().item(), 1e-30)
        if noise > GRAD_NOISE_MAX:
            noisy.append((noise, name))
            continue
        ratio = a.norm().item() / b.norm().item()
        named.append((torch.nn.functional.cosine_similarity(a, b, dim=0).item(), name,
                      b.norm().item(), (a - b).norm().item(), ratio, noise,
                      (a - c).norm().item() / c.norm().item(), b.numel()))
    cos = [r[0] for r in named]
    for c, name, nb, nd, ratio, noise, knoise, _ in sorted(named)[:6]:
        print(f"[train]   lowest cosine {c:.5f} {name}: |g_plain| {nb:.3g}, |g_kernel - g_plain| "
              f"{nd:.3g}, norm ratio {ratio:.5f}; distance from fp32: plain {noise:.3g}, kernel "
              f"{knoise:.3g}", flush=True)
    for c, name, nb, nd, ratio, noise, knoise, n in sorted(named, key=lambda r: -abs(r[4] - 1))[:6]:
        print(f"[train]   norm ratio {ratio:.5f} {name} ({n} elements): cosine {c:.5f}, |g_plain| "
              f"{nb:.3g}; distance from fp32: plain {noise:.3g}, kernel {knoise:.3g}", flush=True)
    for noise, name in sorted(noisy):
        print(f"[train]   left out, plain bf16 distance from fp32 {noise:.3g}: {name}", flush=True)
    worst_ratio = max(abs(r[4] - 1) for r in named if r[7] > 1)
    print(f"[train] gradients, kernel path vs all-plain path: losses {lk.item():.6f} / "
          f"{lp.item():.6f}; over {len(named)} leaves ({len(noisy)} of rounding noise above "
          f"{GRAD_NOISE_MAX} left out) per-leaf cosine min {min(cos):.5f}, mean "
          f"{statistics.mean(cos):.5f} (threshold {GRAD_COSINE_MIN}); |norm ratio - 1| max "
          f"{worst_ratio:.5f} over the leaves of more than one element (threshold "
          f"{GRAD_NORM_TOL})", flush=True)
    check(min(cos) >= GRAD_COSINE_MIN, "kernel-path gradients diverge from the plain path's")
    check(worst_ratio <= GRAD_NORM_TOL, "kernel-path gradient norms differ from the plain path's")
    del g32
    del gk, gp

    # each train kernel alone at the step's shapes, beside its plain version and bound
    gw = torch.Generator(device="cuda").manual_seed(11)
    per_call = {"K6": [], "K7": [], "K8": [], "K9": []}
    for (H, C, heads), n_calls in zip(STAGES + [(8, 768, 32)], (2, 2, 6, 2)):
        x, w, bias, gout, m1, m2 = _train_case(B, H, C, heads, torch.bfloat16, gw)
        cfg_b = (8, heads, 0, 1e-6)
        if H == 8:
            calls = {"K6": (lambda r: wa.window_attention_bwd(x, gout, *w[2:6], bias, 8, heads, 0),
                            lambda r: wa.window_attention_bwd_plain(x, gout, *w[2:6], bias, 8,
                                                                    heads, 0))}
        else:
            with torch.no_grad():
                _, y = wa.swin_block_train_plain(x, *w, bias, m1, m2, *cfg_b)
            ln2_fc = (w[6], w[7], w[8], w[9], w[10])
            calls = {
                "K7": (lambda r: wa.fused_swin_block_train(x, *w, bias, m1, m2, *cfg_b),
                       lambda r: wa.swin_block_train_plain(x, *w, bias, m1, m2, *cfg_b)),
                "K8": (lambda r: wa.mlp_bwd(y, gout, m2, *ln2_fc, 1e-6),
                       lambda r: wa.mlp_bwd_plain(y, gout, m2, *ln2_fc, 1e-6)),
                "K9": (lambda r: wa.attn_ln1_bwd(x, gout, m1, *w[:5], bias, *cfg_b),
                       lambda r: wa.attn_ln1_bwd_plain(x, gout, m1, *w[:5], bias, *cfg_b))}
        for key, (fn, pf) in calls.items():
            with torch.no_grad():
                fn(0)
                ms, pms = timed_ms(fn, 3), timed_ms(pf, 2)
            bms, by = train_bound(key, B, H, C, heads, 2)
            per_call[key] += [(ms, pms, bms, by)] * n_calls
            print(f"[train] {key} B={B} {H}x{H}x{C} heads={heads} bf16: {ms * 1e3:.1f} us per "
                  f"call x {n_calls} per step (bound {bms * 1e3:.1f} us by {by}, "
                  f"{bms / ms:.2%}), plain {pms * 1e3:.1f} us", flush=True)
    stats = {}
    for key, rows in per_call.items():
        stats[key] = {"ms": statistics.mean(r[0] for r in rows),
                      "plain_ms": statistics.mean(r[1] for r in rows),
                      "bound_ms": statistics.mean(r[2] for r in rows), "bound_by": rows[0][3]}
        print(f"[train] {key} share of one step: {len(rows)} calls, "
              f"{sum(r[0] for r in rows):.2f} ms of {step_ms:.2f} ms", flush=True)

    (state, _), pwall, dev_ms, events = profiled(lambda: step(state, batch, 0))
    print(f"[profile] one train step under torch.profiler: wall {pwall:.2f} ms, device "
          f"time {dev_ms:.2f} ms (device idle {1 - dev_ms / pwall:.1%} of the wall), K2 "
          f"{k2_profiled_ms(events):.3f} ms of it", flush=True)
    print(events.table(sort_by="cuda_time_total", row_limit=20), flush=True)
    return per_step, stats


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
    train_err = phase_train_kernels_vs_plain()
    phase_grad_repair()
    phase_fixture_train()
    phase_drivers()
    train_launches, train = phase_train_full_width()
    beam_launches = phase_beam_full_width()

    kernels = [{
        "name": "decode_attn_q8",
        "route": "cuda",
        "source": "zs_aac_tpu_torch/csrc/decode_attn.cu",
        "replaces": "zs_aac_tpu/ops/decode_attn.py:51",
        "launches": launches,
        "beam_launches": beam_launches,
        "max_abs_err": worst["bfloat16"],
        "ms": k1["ms"],
        "graph_ms": k1["graph_ms"],
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
    for key, name, source, line in (
            ("K6", "window_attention_bwd", "swin_train.cu", 757),
            ("K7", "fused_swin_block_train", "window_attn.cu", 1147),
            ("K8", "mlp_bwd", "swin_train.cu", 1229),
            ("K9", "attn_ln1_bwd", "swin_train.cu", 1297)):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"zs_aac_tpu_torch/csrc/{source}",
                        "replaces": f"zs_aac_tpu/ops/window_attn.py:{line}",
                        "launches": int(train_launches[key]), "max_abs_err": train_err[key],
                        **train[key], "library_ms": None})
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
