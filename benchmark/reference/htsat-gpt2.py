"""Plain reference of the ``htsat-gpt2`` configuration: the zero-shot
captioner (the MLP mapper and GPT-2 124M, served as w8a8 weights with an
int8 KV cache).

float32 with TF32 off. It follows GPT-2 (pre-LayerNorm blocks, ``gelu_new``,
the logits on the tied ``wte``) and states the serving precision itself:

- every linear product (c_attn, c_proj, c_fc, the MLP's c_proj and the
  logits on ``wte``) is W8A8: weights quantized per output column
  (``max(amax, 1e-8) / 127``), activations per row (``max(amax / 127,
  1e-8)``), integer products, then both scales;
- the prompt's positions attend over their float keys and values; every
  generated position attends over keys and values quantized per (row,
  head, position) vector, its own row included: the scores ``(q . k8) *
  k_scale / sqrt(d)``, the probabilities times ``v_scale`` on ``v8``;
- the mapper (1024 -> 3840 -> 7680, tanh) stays float.

``bits=4`` puts every one of those quantizations at 4 bits: the control of
the caption cells' check. The reference quantizes from the float weights
itself: it takes nothing the program derived. Nothing here imports the
program or JAX.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.common import (div, quant_cols, quant_rows, qmatmul, seeded_leaves,
                                        strict_fp32, sub_seed)

WEIGHTS_STREAM = 1


def caption_weight_specs(cfg):
    """(name, shape, mean, std) of every leaf, in draw order. Matrices
    N(0, 0.02) (``wpe`` 0.01), biases N(0, 0.02), LayerNorm scales 1 + N(0,
    0.1) and biases N(0, 0.02): GPT-2's initialiser, with the biases and
    LayerNorms drawn too so that a dropped one shows."""
    D, V, P = cfg["n_embd"], cfg["vocab_size"], cfg["n_positions"]
    sizes = cfg["mapper"]["sizes"]
    specs = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        specs += [(f"mapper.{i}.w", (a, b), 0.0, 0.02), (f"mapper.{i}.b", (b,), 0.0, 0.02)]
    specs += [("wte", (V, D), 0.0, 0.02), ("wpe", (P, D), 0.0, 0.01)]
    for i in range(cfg["n_layer"]):
        for ln in ("ln_1", "ln_2"):
            specs += [(f"h.{i}.{ln}.scale", (D,), 1.0, 0.1), (f"h.{i}.{ln}.bias", (D,), 0.0, 0.02)]
        for name, (a, b) in (("attn.c_attn", (D, 3 * D)), ("attn.c_proj", (D, D)),
                             ("mlp.c_fc", (D, 4 * D)), ("mlp.c_proj", (4 * D, D))):
            specs += [(f"h.{i}.{name}.w", (a, b), 0.0, 0.02), (f"h.{i}.{name}.b", (b,), 0.0, 0.02)]
    specs += [("ln_f.scale", (D,), 1.0, 0.1), ("ln_f.bias", (D,), 0.0, 0.02)]
    return specs


def make_caption_weights(cfg, seed: int, device) -> dict:
    """The captioner's float32 weights from ``seed``, in one draw on
    ``device``: ``{"mapper": [{"w" [in, out], "b"}], "wte", "wpe", "h":
    [per layer {"ln_1", "attn": {"c_attn", "c_proj"}, "ln_2", "mlp":
    {"c_fc", "c_proj"}}], "ln_f"}`` (GPT-2's layout, weights [in, out])."""
    flat = seeded_leaves(caption_weight_specs(cfg), sub_seed(seed, WEIGHTS_STREAM), device)

    def lin(p):
        return {"w": flat[p + ".w"], "b": flat[p + ".b"]}

    def ln(p):
        return {"scale": flat[p + ".scale"], "bias": flat[p + ".bias"]}

    n_map = len(cfg["mapper"]["sizes"]) - 1
    return {
        "mapper": [lin(f"mapper.{i}") for i in range(n_map)],
        "wte": flat["wte"], "wpe": flat["wpe"],
        "h": [{"ln_1": ln(f"h.{i}.ln_1"), "ln_2": ln(f"h.{i}.ln_2"),
               "attn": {"c_attn": lin(f"h.{i}.attn.c_attn"), "c_proj": lin(f"h.{i}.attn.c_proj")},
               "mlp": {"c_fc": lin(f"h.{i}.mlp.c_fc"), "c_proj": lin(f"h.{i}.mlp.c_proj")}}
              for i in range(cfg["n_layer"])],
        "ln_f": ln("ln_f"),
    }


def _ln(x, p, eps):
    xc = x - x.mean(dim=-1, keepdim=True)
    var = xc.square().mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _gelu_new(x):
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def _linear(x, p, bits):
    wq, ws = quant_cols(p["w"], bits)
    return qmatmul(x, wq, ws, bits) + p["b"]


def mapper_prefix(weights, cfg, prefixes):
    """The mapper's prefix embeddings [S, prefix_length, n_embd] (float)."""
    h = prefixes.float()
    layers = weights["mapper"]
    for i, p in enumerate(layers):
        h = h @ p["w"] + p["b"]
        if i < len(layers) - 1:
            h = torch.tanh(h)
    return h.reshape(h.shape[0], cfg["mapper"]["prefix_length"], cfg["n_embd"])


@torch.no_grad()
def caption_logits(weights, cfg, prefixes, tokens, bits: int = 8):
    """Teacher-forced logits of greedy captions.

    ``prefixes`` [S, prefix_size] CLAP embeddings, ``tokens`` [S, N] the
    served tokens (a row's tokens past its length are read but cannot
    reach an earlier position). Returns fp32 logits [S, N, vocab]: row
    ``i`` is the distribution the decode chose token ``i`` from (the
    prefill's last position for ``i = 0``)."""
    strict_fp32()
    S, N = tokens.shape
    D, H, eps = cfg["n_embd"], cfg["n_head"], cfg["layer_norm_epsilon"]
    d = D // H
    Lp = cfg["mapper"]["prefix_length"]
    x = torch.cat([mapper_prefix(weights, cfg, prefixes), weights["wte"][tokens[:, :N - 1]]], 1)
    T = x.shape[1]
    x = x + weights["wpe"][:T]
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    prompt = (torch.arange(T, device=x.device) < Lp)[:, None]        # query rows of the prefill
    for blk in weights["h"]:
        qkv = _linear(_ln(x, blk["ln_1"], eps), blk["attn"]["c_attn"], bits)
        q, k, v = (t.reshape(S, T, H, d).transpose(1, 2) for t in qkv.split(D, dim=-1))
        sf = div(q @ k.transpose(-1, -2), math.sqrt(d))
        of = torch.softmax(sf.masked_fill(~causal, -math.inf), -1) @ v
        k8, sk = quant_rows(k, bits)                                   # per (row, head, position)
        v8, sv = quant_rows(v, bits)
        sq = (q @ k8.transpose(-1, -2)) * div(sk.transpose(-1, -2), math.sqrt(d))
        pq = torch.softmax(sq.masked_fill(~causal, -math.inf), -1) * sv.transpose(-1, -2)
        o = torch.where(prompt, of, pq @ v8)
        x = x + _linear(o.transpose(1, 2).reshape(S, T, D), blk["attn"]["c_proj"], bits)
        h = _gelu_new(_linear(_ln(x, blk["ln_2"], eps), blk["mlp"]["c_fc"], bits))
        x = x + _linear(h, blk["mlp"]["c_proj"], bits)
    x = _ln(x[:, Lp - 1:], weights["ln_f"], eps)
    wq, ws = quant_rows(weights["wte"].float(), bits)                 # per vocabulary row
    xq, sx = quant_rows(x, bits)
    return (xq @ wq.t()) * sx * ws[:, 0]


# ---------------------------------------------------------------------------
# The CLAP audio encoder: int16 PCM -> log-mel -> HTSAT -> projection
# ---------------------------------------------------------------------------
#
# float32, TF32 off. HTSAT (Swin over the log-mel folded into a 256 x 256
# image): bn0 on the running statistics, the time axis resized by a bicubic
# matrix (align_corners) and folded into 4 frequency bands, 4 x 4 patches,
# LayerNorm, the stages of shifted-window attention (relative-position bias,
# the -100 shift mask) and GELU MLPs with patch merging between stages, the
# final LayerNorm, the regroup over frequency and the mean, then the
# projection (fc1, ReLU, fc2) and the L2 norm. ``fp8=True`` rounds every
# matmul's two operands to float8 e4m3 with a per-tensor scale: the control
# of the encode cell's check (the configuration serves bf16).

CLAP_STREAM = 3


def _htsat_geometry(clap):
    h = clap["htsat"]
    return (h["spec_size"], h["patch_size"], h["embed_dim"], h["depths"], h["num_heads"],
            h["window_size"], h["mlp_ratio"])


def _stages(clap):
    spec, patch, ed, depths, heads, window, _ = _htsat_geometry(clap)
    res = spec // patch
    for i, depth in enumerate(depths):
        dim = ed * 2 ** i
        for j in range(depth):
            w, shift = window, (0 if j % 2 == 0 else window // 2)
            if res <= w:
                w, shift = res, 0
            yield i, j, dim, heads[i], res, w, shift
        if i < len(depths) - 1:
            res //= 2


def clap_weight_specs(clap):
    """(name, shape, mean, std) of the audio tower's leaves in the port's
    tree layout (``params/audio_enc/...``, ``params/audio_proj/...``,
    ``batch_stats/audio_enc/bn0/...``): kernels LeCun-normal, biases N(0,
    0.02), LayerNorm and BatchNorm scales 1 + N(0, 0.1), relative-position
    tables N(0, 0.02), bn0's running mean N(0, 1) and variance 1 + N(0, 0.1)."""
    spec, patch, ed, depths, heads, window, ratio = _htsat_geometry(clap)
    n_mels, E = clap["audio_args"]["n_mels"], clap["embed_size"]
    a = "params/audio_enc/"
    specs = [(a + "bn0/scale", (n_mels,), 1.0, 0.1), (a + "bn0/bias", (n_mels,), 0.0, 0.02),
             ("batch_stats/audio_enc/bn0/mean", (n_mels,), 0.0, 1.0),
             ("batch_stats/audio_enc/bn0/var", (n_mels,), 1.0, 0.1),
             (a + "patch_proj/kernel", (patch, patch, 1, ed), 0.0, patch ** -1.0),
             (a + "patch_proj/bias", (ed,), 0.0, 0.02)]

    def ln(p, d):
        return [(p + "/scale", (d,), 1.0, 0.1), (p + "/bias", (d,), 0.0, 0.02)]

    def dense(p, din, dout, bias=True):
        out = [(p + "/kernel", (din, dout), 0.0, din ** -0.5)]
        return out + ([(p + "/bias", (dout,), 0.0, 0.02)] if bias else [])

    specs += ln(a + "patch_norm", ed)
    for i, j, dim, h, res, w, shift in _stages(clap):
        b = f"{a}layer{i}_block{j}/"
        specs += ln(b + "norm1", dim) + ln(b + "norm2", dim)
        specs += dense(b + "attn/qkv", dim, 3 * dim) + dense(b + "attn/proj", dim, dim)
        specs += [(b + "attn/rpb_table", ((2 * w - 1) ** 2, h), 0.0, 0.02)]
        specs += dense(b + "fc1", dim, int(dim * ratio)) + dense(b + "fc2", int(dim * ratio), dim)
        if j == depths[i] - 1 and i < len(depths) - 1:
            specs += ln(f"{a}downsample{i}/norm", 4 * dim)
            specs += dense(f"{a}downsample{i}/reduction", 4 * dim, 2 * dim, bias=False)
    nf = ed * 2 ** (len(depths) - 1)
    specs += ln(a + "norm", nf)
    specs += dense("params/audio_proj/fc1", nf, E) + dense("params/audio_proj/fc2", E, E)
    return specs


def make_clap_weights(clap, seed: int, device) -> dict:
    """The audio tower's float32 variables from ``seed``, in one draw on
    ``device``, as the nested ``{"params": ..., "batch_stats": ...}`` tree."""
    flat = seeded_leaves(clap_weight_specs(clap), sub_seed(seed, CLAP_STREAM), device)
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def _fp8(t):
    """Round to float8 e4m3 with a per-tensor scale (amax -> 448)."""
    s = torch.clamp_min(t.abs().amax(), 1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


def _mm(x, w, fp8):
    return _fp8(x) @ _fp8(w) if fp8 else x @ w


def _ln32(x, p, eps=1e-6):
    xc = x - x.mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(xc.square().mean(dim=-1, keepdim=True) + eps) * p["scale"] + p["bias"]


def _hann(n, device):
    k = torch.arange(n, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2 * math.pi * k / n)).float()


def _mel_filterbank(sr, n_fft, n_mels, f_min, f_max, device):
    """Slaney mel filterbank [n_fft/2+1, n_mels] (librosa's ``htk=False``,
    ``norm='slaney'``)."""
    import numpy as np

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) /
                        (np.log(6.4) / 27.0), f / (200.0 / 3))

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                        m * 200.0 / 3)

    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz = mel_to_hz(np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2))
    fd = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fd[:-1, None], ramps[2:] / fd[1:, None]))
    w *= (2.0 / (hz[2:] - hz[:-2]))[:, None]
    return torch.from_numpy(w.T.astype(np.float32)).to(device)


def log_mel(wave, audio):
    """[B, T] float32 -> [B, frames, n_mels] dB (reflect-padded frames,
    periodic Hann window, power spectrum, Slaney mel, 10 log10 max(., 1e-10))."""
    n, hop = audio["n_fft"], audio["hop_length"]
    x = torch.nn.functional.pad(wave[:, None], (n // 2, n // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n, hop) * _hann(n, wave.device)
    spec = torch.fft.rfft(frames, dim=-1)
    power = spec.real.square() + spec.imag.square()
    mel = power @ _mel_filterbank(audio["sr"], n, audio["n_mels"], audio["f_min"],
                                  audio["f_max"], wave.device)
    return 10.0 * torch.log10(torch.clamp_min(mel, 1e-10))


def _cubic(x, a=-0.75):
    ax = abs(x)
    if ax <= 1:
        return (a + 2) * ax ** 3 - (a + 3) * ax ** 2 + 1
    return a * ax ** 3 - 5 * a * ax ** 2 + 8 * a * ax - 4 * a if ax < 2 else 0.0


def _bicubic_matrix(t_in, t_out, device):
    """[t_in, t_out] 1-D bicubic resize weights, align_corners=True, edges clamped."""
    w = torch.zeros(t_in, t_out, dtype=torch.float64)
    scale = (t_in - 1) / (t_out - 1)
    for o in range(t_out):
        src = o * scale
        base = math.floor(src)
        for k in range(-1, 3):
            w[min(max(base + k, 0), t_in - 1), o] += _cubic(src - (base + k))
    return w.float().to(device)


def _window_bias(p, res, w, shift, heads, device):
    """[nW, heads, N, N]: the relative-position bias plus the shift mask."""
    N = w * w
    c = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij")).reshape(2, -1)
    rel = (c[:, :, None] - c[:, None, :]).permute(1, 2, 0)
    idx = (rel[..., 0] + w - 1) * (2 * w - 1) + rel[..., 1] + w - 1
    rpb = p["rpb_table"][idx.reshape(-1).to(device)].reshape(N, N, heads).permute(2, 0, 1)
    nW = (res // w) ** 2
    bias = rpb[None].expand(nW, heads, N, N)
    if shift:
        img = torch.zeros(res, res)
        cnt = 0
        for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
                img[hs, ws] = cnt
                cnt += 1
        win = img.reshape(res // w, w, res // w, w).permute(0, 2, 1, 3).reshape(-1, N)
        mask = torch.where(win[:, None, :] != win[:, :, None], -100.0, 0.0).to(device)
        bias = bias + mask[:, None]
    return bias


def _swin_block(p, x, res, heads, w, shift, fp8):
    B, L, C = x.shape
    N, d = w * w, C // heads
    h = _ln32(x, p["norm1"]).reshape(B, res, res, C)
    if shift:
        h = torch.roll(h, (-shift, -shift), dims=(1, 2))
    h = (h.reshape(B, res // w, w, res // w, w, C).permute(0, 1, 3, 2, 4, 5)
         .reshape(-1, N, C))                                          # [B*nW, N, C]
    qkv = _mm(h, p["attn"]["qkv"]["kernel"], fp8) + p["attn"]["qkv"]["bias"]
    q, k, v = qkv.reshape(-1, N, 3, heads, d).permute(2, 0, 3, 1, 4)
    att = _mm(q * d ** -0.5, k.transpose(-1, -2), fp8)
    nW = (res // w) ** 2
    att = att.reshape(B, nW, heads, N, N) + _window_bias(p["attn"], res, w, shift, heads,
                                                          x.device)[None]
    pr = torch.softmax(att, dim=-1).reshape(-1, heads, N, N)
    o = _mm(pr, v, fp8).transpose(1, 2).reshape(-1, N, C)
    o = _mm(o, p["attn"]["proj"]["kernel"], fp8) + p["attn"]["proj"]["bias"]
    o = (o.reshape(B, res // w, res // w, w, w, C).permute(0, 1, 3, 2, 4, 5)
         .reshape(B, res, res, C))
    if shift:
        o = torch.roll(o, (shift, shift), dims=(1, 2))
    x = x + o.reshape(B, L, C)
    h = _mm(_ln32(x, p["norm2"]), p["fc1"]["kernel"], fp8) + p["fc1"]["bias"]
    h = torch.nn.functional.gelu(h)
    return x + _mm(h, p["fc2"]["kernel"], fp8) + p["fc2"]["bias"]


@torch.no_grad()
def clap_audio_embed(weights, clap, pcm, fp8: bool = False):
    """int16 PCM [B, T] at ``audio_args.sr`` (a tensor) -> L2-normalized
    audio embeddings [B, embed_size] float32."""
    strict_fp32()
    audio = clap["audio_args"]
    spec_size, patch, ed, depths, heads, window, _ = _htsat_geometry(clap)
    T = audio["sr"] * audio["max_length"]
    wave = pcm.float() / 32768.0
    wave = torch.nn.functional.pad(wave, (0, max(0, T - wave.shape[1])))[:, :T]
    x = log_mel(wave, audio)                                           # [B, F, mels]
    p, st = weights["params"]["audio_enc"], weights["batch_stats"]["audio_enc"]["bn0"]
    x = (x - st["mean"]) * torch.rsqrt(st["var"] + 1e-5) * p["bn0"]["scale"] + p["bn0"]["bias"]
    B, Tf, Fq = x.shape
    fr = spec_size // audio["n_mels"]
    tT, tF = spec_size * fr, spec_size // fr
    if Tf < tT:
        x = torch.einsum("btf,to->bof", x, _bicubic_matrix(Tf, tT, x.device))
    if Fq < tF:
        x = torch.einsum("btf,fo->bto", x, _bicubic_matrix(Fq, tF, x.device))
    x = x.transpose(1, 2).reshape(B, tF, fr, tT // fr).transpose(1, 2).reshape(B, spec_size, -1)
    Hp = spec_size // patch
    x = (x.reshape(B, Hp, patch, Hp, patch).permute(0, 1, 3, 2, 4).reshape(B, Hp * Hp, -1))
    x = _mm(x, p["patch_proj"]["kernel"].reshape(patch * patch, -1), fp8) + p["patch_proj"]["bias"]
    x = _ln32(x, p["patch_norm"])
    for i, j, dim, h, res, w, shift in _stages(clap):
        x = _swin_block(p[f"layer{i}_block{j}"], x, res, h, w, shift, fp8)
        if j == depths[i] - 1 and i < len(depths) - 1:
            C = x.shape[-1]
            g = x.reshape(B, res, res, C)
            g = torch.cat([g[:, 0::2, 0::2], g[:, 1::2, 0::2], g[:, 0::2, 1::2],
                           g[:, 1::2, 1::2]], -1).reshape(B, -1, 4 * C)
            x = _mm(_ln32(g, p[f"downsample{i}"]["norm"]),
                    p[f"downsample{i}"]["reduction"]["kernel"], fp8)
    x = _ln32(x, p["norm"])
    SF = spec_size // patch // 2 ** (len(depths) - 1)
    C = x.shape[-1]
    x = x.transpose(1, 2).reshape(B, C, SF, SF)
    cfb = SF // fr
    x = x.reshape(B, C, SF // cfb, cfb, SF).permute(0, 1, 3, 2, 4).reshape(B, C, -1)
    feats = x.mean(dim=-1)
    pj = weights["params"]["audio_proj"]
    h = torch.relu(_mm(feats, pj["fc1"]["kernel"], fp8) + pj["fc1"]["bias"])
    e = _mm(h, pj["fc2"]["kernel"], fp8) + pj["fc2"]["bias"]
    return e / torch.clamp_min(torch.linalg.vector_norm(e, dim=-1, keepdim=True), 1e-12)
