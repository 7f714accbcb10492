"""Tiny configurations and mixes for the CPU tests: the files' keys at sizes
a test run holds, the same code paths."""

import copy

from benchmark import harness

TINY_CONFIGS = {
    "htsat-gpt2": dict(n_embd=64, n_head=4, n_layer=2, n_positions=128, vocab_size=250,
                       mapper={"type": "mlp", "sizes": [32, 160, 320], "prefix_length": 5},
                       serving_new_tokens=6),
    "mistral7b-lora": dict(hidden_size=64, intermediate_size=128, num_attention_heads=4,
                           num_hidden_layers=2, num_key_value_heads=2, head_dim=16,
                           vocab_size=250, lora={"r": 4, "alpha": 8},
                           mapper={"type": "mlp", "sizes": [32, 160, 320], "prefix_length": 5},
                           serving_new_tokens=6, serving_tag_ids=[5, 6, 7]),
}


TINY_HTSAT = {"spec_size": 64, "patch_size": 4, "embed_dim": 8, "depths": [2, 2],
              "num_heads": [2, 4], "window_size": 4, "mlp_ratio": 4.0}
TINY_CLAP = {"audio_args": {"sr": 8000, "n_fft": 256, "hop_length": 80, "f_min": 50,
                            "f_max": 4000, "n_mels": 16, "max_length": 1, "mono": True},
             "embed_size": 32, "compute_dtype": "float32", "htsat": TINY_HTSAT,
             "htsat_kwargs": dict(TINY_HTSAT, patch_stride=4, n_mels=16)}


def tiny_config(name: str) -> dict:
    cfg = copy.deepcopy(harness.load_json("configs", name + ".json"))
    if "clap" in cfg:
        cfg["clap"].update(copy.deepcopy(TINY_CLAP))
    for k, v in TINY_CONFIGS[name].items():
        if k.startswith("serving_"):
            cfg["serving"][k[len("serving_"):]] = v
        else:
            cfg[k] = v
    return cfg


def tiny_mix(traffic: str, batch: int = 4) -> dict:
    mix = copy.deepcopy(harness.load_json("mixes", traffic + ".json"))
    mix.update(batch=batch, pool_batches=2, check_rows=3, check_block=2)
    if "pcm_sr" in mix:
        mix["pcm_sr"] = TINY_CLAP["audio_args"]["sr"]
    return mix


def tiny_ctx(cell_name: str, seed: int = 7, limit=1e9):
    cell = {w["name"]: w for w in harness.manifest()["workloads"]}[cell_name]
    names = harness.load_json("workloads", cell_name + ".json")["checks"]
    return harness.Ctx(cell, seed, "cpu", config=tiny_config(cell["config"]),
                       mix=tiny_mix(cell["traffic"]), limits={n: {"limit": limit} for n in names})
