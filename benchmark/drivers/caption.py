"""Offline greedy captioning of a bank of CLAP embeddings: the caption cells.

The mix gives the batch (``batch`` clips a chunk, as the predict drivers
chunk a bank) and the pool of distinct chunks made at set-up
(``pool_batches``): seeded unit-norm embeddings, on the host as the drivers
hold a bank. A batch of the window is one chunk through the configuration's
program (``programs/<program>.py``: prefix in, tokens and lengths back on
the host). Every batch does the same work: the loop stops early only where
every row has stopped, which seeded weights never reach at these batches.

The check (after the window, the program freed): a sample of the captions
served in the window, drawn from the seed with the longest among them, is
run through the configuration's plain reference with its served tokens
(teacher-forced), and the widest gap by which a served token's reference
logit lies below the reference's best is compared with the cell's limit.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Any, List

import numpy as np
import torch

from benchmark.reference.common import sub_seed

POOL_STREAM, SAMPLE_STREAM = 11, 12
FAR = 1e30   # the reading of an answer that cannot be compared (a finite number, for JSON)


@dataclasses.dataclass
class State:
    ctx: Any
    captioner: Any
    program: Any
    pool: np.ndarray                      # [pool_batches, B, prefix_size] float32
    out: List = dataclasses.field(default_factory=list)   # (pool index, tokens, lengths)


def make_pool(ctx) -> np.ndarray:
    mix, cfg = ctx.mix, ctx.config
    P, B, E = mix["pool_batches"], mix["batch"], cfg["mapper"]["sizes"][0]
    g = torch.Generator(device=ctx.device).manual_seed(sub_seed(ctx.seed, POOL_STREAM))
    x = torch.randn(P * B, E, generator=g, device=ctx.device)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x.reshape(P, B, E).cpu().numpy()


def setup(ctx) -> State:
    prog = ctx.program(ctx.config["program"])
    ref = ctx.reference()
    with ctx.phase("build"):
        if prog.KERNELS and torch.device(ctx.device).type == "cuda":
            from zs_aac_tpu_torch.utils.cuda_build import build, load_library

            build(list(prog.KERNELS))
            for name in prog.KERNELS:
                load_library(name)
    with ctx.phase("weights"):
        weights = ref.make_caption_weights(ctx.config, ctx.seed, ctx.device)
    with ctx.phase("program"):
        captioner = prog.Captioner(weights, ctx.config, ctx.device, ctx.mix["batch"])
        del weights
        gc.collect()
    with ctx.phase("inputs"):
        pool = make_pool(ctx)
    with ctx.phase("warm-up"):
        captioner.caption(pool[0])
    return State(ctx, captioner, prog, pool)


def batch(state: State, j: int) -> int:
    p = j % len(state.pool)
    toks, lens = state.captioner.caption(state.pool[p])
    state.out.append((p, toks, lens))
    return len(lens)


def counters(state: State) -> dict:
    return state.program.counters()


def info(state: State) -> dict:
    cfg = state.ctx.config
    return {"batch": state.ctx.mix["batch"], "new_tokens": cfg["serving"]["new_tokens"]}


def served_gap(logits: torch.Tensor, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per row, the widest gap ``max(logits) - logits[served token]`` over
    the row's served positions (``FAR`` for a token outside the vocabulary)."""
    V = logits.shape[-1]
    ok = (tokens >= 0) & (tokens < V)
    picked = logits.gather(-1, tokens.clamp(0, V - 1)[..., None])[..., 0]
    gap = torch.where(ok, logits.amax(-1) - picked, torch.full_like(picked, FAR))
    served = torch.arange(tokens.shape[1], device=tokens.device)[None] < lengths[:, None]
    return torch.where(served, gap, torch.zeros_like(gap)).amax(-1)


def sample(state: State):
    """The checked captions: (prefixes [S, E], tokens [S, N], lengths [S])
    as numpy, the longest served caption first, the rest drawn from the seed."""
    lens = np.concatenate([o[2] for o in state.out])
    n, S = len(lens), min(state.ctx.mix["check_rows"], len(lens))
    first = int(np.argmax(lens))
    rng = np.random.default_rng(sub_seed(state.ctx.seed, SAMPLE_STREAM))
    rest = rng.choice(np.delete(np.arange(n), first), S - 1, replace=False)
    B = len(state.out[0][2])
    pick = [first, *sorted(int(i) for i in rest)]
    prefixes = np.stack([state.pool[state.out[i // B][0]][i % B] for i in pick])
    tokens = np.stack([state.out[i // B][1][i % B] for i in pick])
    return prefixes, tokens, lens[pick]


def reference_logits(ctx, prefixes, tokens, bits: int = 8, **kw):
    """The plain reference's teacher-forced logits of the sampled captions,
    ``check_block`` rows at a time, on weights made again from the seed
    (``kw`` to the reference: a witness's options)."""
    ref = ctx.reference()
    weights = ref.make_caption_weights(ctx.config, ctx.seed, ctx.device)
    out = []
    blk = ctx.mix["check_block"]
    for s in range(0, len(prefixes), blk):
        p = torch.from_numpy(prefixes[s:s + blk]).to(ctx.device)
        t = torch.from_numpy(tokens[s:s + blk]).to(ctx.device)
        out.append(ref.caption_logits(weights, ctx.config, p, t, bits=bits, **kw))
    return torch.cat(out)


def check(state: State, ctx) -> list:
    prefixes, tokens, lens = sample(state)
    state.captioner = None                      # the program's state goes first
    gc.collect()
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()
    logits = reference_logits(ctx, prefixes, tokens)
    dev = logits.device
    gap = served_gap(logits, torch.from_numpy(tokens).to(dev), torch.from_numpy(lens).to(dev))
    return [{"name": "logit_gap", "value": float(gap.max()),
             "limit": ctx.limits["logit_gap"]["limit"]}]
