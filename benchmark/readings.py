"""Readings that set a cell's check limit: the program's number on many
seeds and its control's (the reference at the next precision down: 4-bit
where the configuration states 8, fp8 where it states bf16) on the same
inputs, each seed's program built, run for whole batches at the cell's own
size and checked as a run checks it, all in one process.

    python3 benchmark/readings.py --workload <cell> --seeds 101 102 ... [--batches 2]

One JSON line per seed. Caption cells: the program's widest logit gap and
the control's, the reference's gap of the token the control puts first at
each position of the same captions. Encode cells: the widest distance of
the program's unit embeddings from the reference's, and the fp8 control's.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def caption_readings(ctx, batches: int, witness=None) -> dict:
    import gc

    import torch

    drv = harness.load_module("drivers", ctx.mix["driver"])
    st = drv.setup(ctx)
    for j in range(batches):
        drv.batch(st, j)
    prefixes, tokens, lens = drv.sample(st)
    st.captioner = None
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = drv.reference_logits(ctx, prefixes, tokens)
    t_ref = time.perf_counter() - t0
    ctl = drv.reference_logits(ctx, prefixes, tokens, bits=4)
    dev = ref.device
    toks, ls = torch.from_numpy(tokens).to(dev), torch.from_numpy(lens).to(dev)
    gap = drv.served_gap(ref, toks, ls)
    ctl_gap = drv.served_gap(ref, ctl.argmax(-1), ls)
    top2 = ref.topk(2, -1).values
    extra = {}
    if witness:         # the reference in lower activations, read as the control is
        wit = drv.reference_logits(ctx, prefixes, tokens, act_dtype=getattr(torch, witness))
        extra["witness_gap"] = float(drv.served_gap(ref, wit.argmax(-1), ls).max())
        extra["witness_activations"] = witness
    return {"gap": float(gap.max()), "control_gap": float(ctl_gap.max()), **extra,
            "gap_rows": [round(float(g), 6) for g in gap],
            "served_tokens": int(lens.sum()), "reference_s": t_ref,
            "median_top2_margin": float((top2[..., 0] - top2[..., 1]).median()),
            "max_abs_logit": float(ref.abs().max()), "setup": ctx.setup_split}


def encode_readings(ctx, batches: int, witness=None) -> dict:
    import gc

    import torch

    drv = harness.load_module("drivers", ctx.mix["driver"])
    st = drv.setup(ctx)
    for j in range(batches):
        drv.batch(st, j)
    pcm, emb = drv.sample(st)
    st.encoder = None
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = drv.reference_embed(ctx, pcm)
    t_ref = time.perf_counter() - t0
    ctl = drv.reference_embed(ctx, pcm, fp8=True)
    e = torch.from_numpy(emb).to(ref.device)
    rows = torch.linalg.vector_norm(e - ref, dim=-1)
    return {"dist": drv.embed_distance(e, ref), "control_dist": drv.embed_distance(ctl, ref),
            "dist_rows": [round(float(r), 6) for r in rows], "reference_s": t_ref,
            "setup": ctx.setup_split}


READINGS = {"caption": caption_readings, "encode": encode_readings}


def main(argv=None) -> int:
    import argparse

    import torch

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--batches", type=int, default=2)
    p.add_argument("--activations", default=None,
                   help="serve in this activation dtype instead of the configuration's "
                        "(a witness run, not the cell)")
    p.add_argument("--fuse", choices=("on", "off"), default=None,
                   help="fuse the int8 q/k/v (and gate/up) weights or not, instead of the "
                        "configuration's choice (a witness run, not the cell)")
    p.add_argument("--witness", default=None,
                   help="caption cells: also read the plain reference with its activations "
                        "rounded to this dtype, as the control is read")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 3
    cell = {w["name"]: w for w in harness.manifest()["workloads"]}[args.workload]
    for seed in args.seeds:
        ctx = harness.Ctx(cell, seed, torch.device("cuda"))
        if args.activations:
            ctx.config["serving"]["activations"] = args.activations
        if args.fuse:
            ctx.config["serving"]["fuse_qkv"] = args.fuse
        out = READINGS[ctx.mix["driver"]](ctx, args.batches, args.witness)
        if args.activations:
            out["activations"] = args.activations
        if args.fuse:
            out["fuse_qkv"] = args.fuse
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
