#!/usr/bin/env python3
"""Device time of the encode and of a train step, for two checkouts alike.

Run from the repository root: ``python3 examples/profile_paths.py [--root
DIR]``. ``--root`` imports ``zs_aac_tpu_torch`` from another checkout (an
unpacked ``git archive`` of the parent commit, say); the configurations and
helpers come from this checkout's ``chip_smoke.py``, so both trees are
measured the same way.

It builds the full-width encode of ``chip_smoke.py`` phase 8 (HTSAT + ASE
projection, bf16, B = 64 ten-second waves, seeded weights) and the train
step of phase 13 (HTSAT + BERT-base, Adam, spec augmentation and drop path,
bf16 over fp32 parameters, 30 token ids), warms each, and profiles three
encodes and three steps with ``chip_smoke.profiled``. In a process of its
own the profiler keeps K2, which ``chip_smoke.py``'s profiles lose after
its large decode profile. It prints, per call, the host's wall, the
device's busy time, its idle share and K2's device time. About 60 s.
"""

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    args = sys.argv[1:]
    root = HERE
    if args[:1] == ["--root"] and len(args) == 2:
        root = os.path.abspath(args[1])
    elif args:
        sys.exit(__doc__)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import dataclasses

    import torch

    from zs_aac_tpu_torch.models.ase import ASE, init_ase
    from zs_aac_tpu_torch.models.convert import cast_floating
    from zs_aac_tpu_torch.ops.logmel import LogMelConfig
    from zs_aac_tpu_torch.train.contrastive import (create_ase_state, make_ase_train_step,
                                                    make_encode_fns)
    from zs_aac_tpu_torch.train.pretrain import build_ase_from_config, build_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"package from {root}; {torch.cuda.get_device_name(0)}", flush=True)
    B, T, L = 64, 10 * 32000, 30
    g = torch.Generator(device="cuda").manual_seed(10)
    batch = cs._train_batch(B, T, L, g)

    _, cfg = build_ase_from_config(cs.EXTRACT_CONFIG)
    mel_cfg = LogMelConfig.from_dict(cs.EXTRACT_CONFIG["audio_args"])
    with torch.no_grad():
        variables = cast_floating(init_ase(cfg, seed=0, device="cuda"), torch.bfloat16)
    n_stages = len(ASE(cfg).audio_enc.depths)
    ase = ASE(dataclasses.replace(cfg, fused_attn=True, fused_block=tuple(range(n_stages - 1))))
    enc_a, _ = make_encode_fns(ase, mel_cfg, device="cuda")
    for _ in range(2):
        enc_a(variables, batch["wave"])
    for i in range(3):
        _, wall, dev, events = cs.profiled(lambda: enc_a(variables, batch["wave"]))
        print(f"[encode {i}] wall {wall:.2f} ms, device {dev:.2f} ms (idle {1 - dev / wall:.1%}), "
              f"K2 {cs.k2_profiled_ms(events):.3f} ms", flush=True)
    del variables, ase, enc_a

    ase, _ = build_ase_from_config(cs.TRAIN_CONFIG, device="cuda")
    optimizer = build_optimizer(cs.TRAIN_CONFIG, steps_per_epoch=1)
    state = create_ase_state(0, ase, optimizer, device="cuda")
    step = make_ase_train_step(ase, optimizer, LogMelConfig.from_dict(
        cs.TRAIN_CONFIG["audio_args"]), device="cuda")
    state, _ = step(state, batch, 0)
    for i in range(3):
        (state, _), wall, dev, events = cs.profiled(lambda: step(state, batch, 0))
        print(f"[step {i}] wall {wall:.2f} ms, device {dev:.2f} ms (idle {1 - dev / wall:.1%}), "
              f"K2 {cs.k2_profiled_ms(events):.3f} ms", flush=True)


if __name__ == "__main__":
    main()
