"""The system under test of the Mistral caption cells: the port's
multilingual captioner as ``train/predict_multilingual.py --q8`` serves a
chunk (``train_prompt_multilingual.py::run_multilingual_validation``).

A chunk is CLAP embeddings on the host (float32 numpy), moved to the card,
``models/caption_mistral.py::mistral_caption_embeddings`` (the MLP mapper,
then the language tag's tokens), then
``decoding/greedy.py::mistral_greedy_decode(..., q8_cache=True)`` over
``quantize_mistral_int8(base, "w8a8", fuse=...)`` with the float LoRA on
top, tokens and lengths back on the host. The weights are the benchmark's
(``reference/<config>.py``); the port quantizes and fuses them itself.
"""

from __future__ import annotations

import torch

KERNELS = ()


def counters() -> dict:
    return {}


class Captioner:
    def __init__(self, weights: dict, cfg: dict, device, batch: int):
        from zs_aac_tpu_torch.models.caption_mistral import MistralCaptionConfig
        from zs_aac_tpu_torch.models.mapper import make_mapper
        from zs_aac_tpu_torch.models.mistral import MistralConfig, quantize_mistral_int8

        serving = cfg["serving"]
        if (serving["weights"], serving["kv_cache"]) != ("w8a8", "int8"):
            raise ValueError(f"mistral_caption serves w8a8 + int8 KV only, not {serving}")
        mcfg = MistralConfig(vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
                             n_layers=cfg["num_hidden_layers"],
                             n_heads=cfg["num_attention_heads"],
                             n_kv_heads=cfg["num_key_value_heads"],
                             intermediate_size=cfg["intermediate_size"],
                             rope_theta=cfg["rope_theta"], rms_norm_eps=cfg["rms_norm_eps"],
                             sliding_window=cfg["sliding_window"],
                             max_positions=cfg["max_position_embeddings"])
        if mcfg.head_dim != cfg["head_dim"]:
            raise ValueError(f"head_dim {cfg['head_dim']} != hidden / heads {mcfg.head_dim}")
        m = cfg["mapper"]
        self.ccfg = MistralCaptionConfig(prefix_length=m["prefix_length"],
                                         prefix_size=m["sizes"][0], mapping_type="mlp",
                                         islang=1, lora_r=cfg["lora"]["r"],
                                         lora_alpha=cfg["lora"]["alpha"], mistral=mcfg)
        self.device = torch.device(device)
        mapper = make_mapper("mlp", m["sizes"][0], mcfg.hidden_size, m["prefix_length"],
                             device=self.device)
        with torch.no_grad():
            for lin, p in zip(mapper.layers, weights["mapper"]):
                lin.weight.copy_(p["w"].t())
                lin.bias.copy_(p["b"])
        dtype = getattr(torch, serving["activations"])
        base = {"embed": weights["embed"].to(dtype).clone(), "norm": weights["norm"].to(dtype),
                "lm_head": weights["lm_head"].to(dtype),
                "layers": [{"attn": {k: v.to(dtype) for k, v in lp["attn"].items()},
                            "mlp": {k: v.to(dtype) for k, v in lp["mlp"].items()},
                            "ln1": lp["ln1"].to(dtype), "ln2": lp["ln2"].to(dtype)}
                           for lp in weights["layers"]]}
        fuse = {"auto": 192 <= batch < 384, "on": True, "off": False}[serving["fuse_qkv"]]
        quantized = quantize_mistral_int8(base, "w8a8", fuse=fuse)
        del base
        lora = _clone(weights["lora"])     # the benchmark's buffers are freed after set-up
        self.params = {"mapper": mapper, "lora": lora, "mistral": quantized}
        self.tags = torch.tensor(serving["tag_ids"], dtype=torch.int64, device=self.device)
        self.eos = serving["eos_token_id"]
        self.new_tokens = serving["new_tokens"]

    def caption(self, prefix):
        """``prefix`` [B, prefix_size] float32 numpy -> (tokens [B, new_tokens]
        int64, lengths [B] int64), numpy."""
        from zs_aac_tpu_torch.decoding.greedy import mistral_greedy_decode
        from zs_aac_tpu_torch.models.caption_mistral import mistral_caption_embeddings

        with torch.no_grad():
            x = torch.from_numpy(prefix).to(self.device)
            tags = self.tags[None].expand(x.shape[0], -1)
            emb = mistral_caption_embeddings(self.params, self.ccfg, x, None, tags)
            toks, lens = mistral_greedy_decode(self.params["mistral"], self.ccfg.mistral, emb,
                                               self.params["lora"], self.new_tokens, self.eos,
                                               q8_cache=True)
        return toks.cpu().numpy(), lens.cpu().numpy()


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()
