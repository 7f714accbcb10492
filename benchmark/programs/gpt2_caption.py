"""The system under test of the GPT-2 caption cells: the port's zero-shot
captioner as ``train/predict_prompt.py --q8`` serves a chunk of the bank.

A chunk is CLAP embeddings on the host (float32 numpy), moved to the card,
``models/caption.py::caption_embeddings`` (the MLP mapper), then
``decoding/greedy.py::greedy_decode_q8`` over ``quantize_gpt2_int8(...,
"w8a8")`` weights (int8 GEMMs through ``torch._int_mm``, the int8 KV cache,
every attention through kernel K1), tokens and lengths back on the host.
The weights are the benchmark's (``reference/<config>.py``), put into the
port's layout; the port quantizes them itself.
"""

from __future__ import annotations

import torch

KERNELS = ("decode_attn",)


def counters() -> dict:
    from zs_aac_tpu_torch.ops.decode_attn import decode_attn_q8

    return {"K1.launches": decode_attn_q8.launches,
            "K1.bf16_softmax_launches": decode_attn_q8.bf16_softmax_launches}


class Captioner:
    def __init__(self, weights: dict, cfg: dict, device, batch: int):
        from zs_aac_tpu_torch.models.caption import CaptionConfig
        from zs_aac_tpu_torch.models.gpt2 import GPT2Config, quantize_gpt2_int8
        from zs_aac_tpu_torch.models.mapper import make_mapper

        serving = cfg["serving"]
        if (serving["weights"], serving["kv_cache"]) != ("w8a8", "int8"):
            raise ValueError(f"gpt2_caption serves w8a8 + int8 KV only, not {serving}")
        self.dtype = getattr(torch, serving["activations"])
        gcfg = GPT2Config(vocab_size=cfg["vocab_size"], n_positions=cfg["n_positions"],
                          n_embd=cfg["n_embd"], n_layer=cfg["n_layer"], n_head=cfg["n_head"],
                          layer_norm_epsilon=cfg["layer_norm_epsilon"])
        m = cfg["mapper"]
        self.ccfg = CaptionConfig(prefix_length=m["prefix_length"], prefix_size=m["sizes"][0],
                                  mapping_type="mlp", gpt2=gcfg)
        self.device = torch.device(device)
        mapper = make_mapper("mlp", m["sizes"][0], gcfg.n_embd, m["prefix_length"],
                             device=self.device)
        with torch.no_grad():
            for lin, p in zip(mapper.layers, weights["mapper"]):
                lin.weight.copy_(p["w"].t())
                lin.bias.copy_(p["b"])
        gpt2 = {k: weights[k] for k in ("wte", "wpe", "h", "ln_f")}
        gpt2 = _cast(gpt2, self.dtype)
        self.params = {"mapper": mapper.to(self.dtype), "gpt2": gpt2}
        self.serving = quantize_gpt2_int8(gpt2, "w8a8")
        self.stop = (cfg["serving"]["stop_token_id"], cfg["serving"]["extra_stop_id"])
        self.new_tokens = cfg["serving"]["new_tokens"]

    def caption(self, prefix):
        """``prefix`` [B, prefix_size] float32 numpy -> (tokens [B, new_tokens]
        int64, lengths [B] int64), numpy."""
        from zs_aac_tpu_torch.decoding.greedy import greedy_decode_q8
        from zs_aac_tpu_torch.models.caption import caption_embeddings

        with torch.no_grad():
            x = torch.from_numpy(prefix).to(self.device).to(self.dtype)
            emb = caption_embeddings(self.params, self.ccfg, x)
            toks, lens = greedy_decode_q8(self.serving, self.ccfg.gpt2, emb, self.new_tokens,
                                          *self.stop)
        return toks.cpu().numpy(), lens.cpu().numpy()


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)
