"""Building a CLAP embedding bank: the encode cells.

The mix gives the batch (``batch`` clips of the configuration's
``max_length`` seconds), the PCM's rate (``pcm_sr``) and content (noise and
tones, ``make_pool``) and the pool of distinct batches made at set-up
(``pool_batches``), held on the host as int16 PCM as the bank build ships
it. A batch of the window is one pool entry through the
configuration's encoder program (PCM handed over -> embeddings on the host);
its wall is that batch's latency. Every batch does the same work.

The check (after the window, the program freed): a sample of the window's
embeddings drawn from the seed is encoded again by the plain reference from
the same PCM, and the widest distance ``|e - e_ref|`` between unit
embeddings is compared with the cell's limit.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Any, List

import numpy as np
import torch

from benchmark.reference.common import sub_seed

POOL_STREAM, SAMPLE_STREAM = 21, 22
FAR = 1e30   # the reading of an answer that cannot be compared (a finite number, for JSON)


@dataclasses.dataclass
class State:
    ctx: Any
    encoder: Any
    program: Any
    pool: np.ndarray                      # [pool_batches, B, T] int16
    out: List = dataclasses.field(default_factory=list)   # (pool index, embeddings)


def make_pool(ctx) -> np.ndarray:
    """The pool of int16 PCM batches: each clip white noise at its own
    loudness plus ``tones`` sinusoids of their own frequency, phase and
    loudness (loudness log-uniform over ``level_range`` int16 steps,
    frequencies uniform up to ``tone_max_hz``), so that clips differ."""
    mix, audio = ctx.mix, ctx.config["clap"]["audio_args"]
    P, B, sr = mix["pool_batches"], mix["batch"], mix["pcm_sr"]
    T, n, K = audio["max_length"] * sr, mix["pool_batches"] * mix["batch"], mix["tones"]
    lo, hi = (float(np.log(v)) for v in mix["level_range"])
    g = torch.Generator(device=ctx.device).manual_seed(sub_seed(ctx.seed, POOL_STREAM))
    u = torch.rand(n, 3 * K + 1, generator=g, device=ctx.device, dtype=torch.float64)
    level = lambda v: torch.exp(lo + (hi - lo) * v)
    out = torch.empty(n, T, dtype=torch.int16, device=ctx.device)
    t = torch.arange(T, device=ctx.device, dtype=torch.float64)[None] / sr
    for rows in (slice(i, i + B) for i in range(0, n, B)):           # a batch at a time
        v = u[rows]
        x = torch.randn(B, T, generator=g, device=ctx.device) * level(v[:, :1]).float()
        for k in range(K):
            f, phase, amp = (v[:, c:c + 1] for c in (1 + 3 * k, 2 + 3 * k, 3 + 3 * k))
            x += (level(amp) * torch.sin(2 * np.pi * (f * mix["tone_max_hz"] * t + phase))).float()
        out[rows] = x.round_().clamp_(-32768, 32767).to(torch.int16)
    return out.reshape(P, B, T).cpu().numpy()


def setup(ctx) -> State:
    clap = ctx.config["clap"]
    prog = ctx.program(clap["program"])
    ref = ctx.reference()
    with ctx.phase("build"):
        if prog.KERNELS and torch.device(ctx.device).type == "cuda":
            from zs_aac_tpu_torch.utils.cuda_build import build, load_library

            build(list(prog.KERNELS))
            for name in prog.KERNELS:
                load_library(name)
    with ctx.phase("weights"):
        weights = ref.make_clap_weights(clap, ctx.seed, ctx.device)
    with ctx.phase("program"):
        encoder = prog.Encoder(weights, clap, ctx.device, ctx.mix["pcm_sr"])
        del weights
        gc.collect()
    with ctx.phase("inputs"):
        pool = make_pool(ctx)
    with ctx.phase("warm-up"):
        encoder.encode(pool[0])
    return State(ctx, encoder, prog, pool)


def batch(state: State, j: int) -> int:
    p = j % len(state.pool)
    emb = state.encoder.encode(state.pool[p])
    state.out.append((p, emb))
    return len(emb)


def counters(state: State) -> dict:
    return state.program.counters()


def info(state: State) -> dict:
    return {"batch": state.ctx.mix["batch"]}


def sample(state: State):
    """(PCM [S, T] int16, program embeddings [S, E]) of the checked rows,
    drawn from the seed over every embedding of the window."""
    B = len(state.out[0][1])
    n, S = B * len(state.out), state.ctx.mix["check_rows"]
    rng = np.random.default_rng(sub_seed(state.ctx.seed, SAMPLE_STREAM))
    pick = sorted(int(i) for i in rng.choice(n, min(S, n), replace=False))
    pcm = np.stack([state.pool[state.out[i // B][0]][i % B] for i in pick])
    emb = np.stack([state.out[i // B][1][i % B] for i in pick])
    return pcm, emb


def reference_embed(ctx, pcm, fp8: bool = False):
    ref = ctx.reference()
    clap = ctx.config["clap"]
    weights = ref.make_clap_weights(clap, ctx.seed, ctx.device)
    blk = ctx.mix["check_block"]
    return torch.cat([ref.clap_audio_embed(weights, clap,
                                           torch.from_numpy(pcm[s:s + blk]).to(ctx.device), fp8)
                      for s in range(0, len(pcm), blk)])


def embed_distance(a: torch.Tensor, b: torch.Tensor) -> float:
    """The widest L2 distance between matching rows (a non-finite row reads
    ``FAR``)."""
    d = torch.linalg.vector_norm(a.float() - b.float(), dim=-1)
    return float(torch.where(torch.isfinite(d), d, torch.full_like(d, FAR)).max())


def check(state: State, ctx) -> list:
    pcm, emb = sample(state)
    state.encoder = None
    gc.collect()
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_embed(ctx, pcm)
    return [{"name": "embed_dist", "value": embed_distance(torch.from_numpy(emb).to(ref.device), ref),
             "limit": ctx.limits["embed_dist"]["limit"]}]
