"""The system under test of the DeepSeek caption cell: the port's
multilingual captioner over a DeepSeek-V2 base, served in bf16.

A chunk is CLAP embeddings on the host (float32 numpy), moved to the card,
``models/caption_mistral.py::mistral_caption_embeddings`` (the MLP mapper,
then the language tag's tokens), then
``decoding/greedy.py::deepseek_greedy_decode`` over
``prepare_deepseek_v2``'s serving form (MLA over the latent cache, the
routed experts through ``torch._grouped_mm``; on a card each step a
replay of the captioner's ``StepGraphs``, kept from batch to batch), tokens
and lengths back on the host. The weights are the benchmark's (``reference/<config>.py``),
already in the port's layout: the matrices and the stacked experts are
taken as they are, not copied.
"""

from __future__ import annotations

import torch

KERNELS = ()


def counters() -> dict:
    from zs_aac_tpu_torch.models.deepseek import MOE_COUNTERS

    return MOE_COUNTERS.read()


class Captioner:
    def __init__(self, weights: dict, cfg: dict, device, batch: int):
        from zs_aac_tpu_torch.models.caption_mistral import MistralCaptionConfig
        from zs_aac_tpu_torch.models.deepseek import (DeepseekV2Config, StepGraphs,
                                                      prepare_deepseek_v2)
        from zs_aac_tpu_torch.models.mapper import make_mapper

        serving = cfg["serving"]
        if (serving["weights"], serving["kv_cache"]) != ("bf16", "latent-bf16"):
            raise ValueError(f"deepseek_caption serves bf16 + the bf16 latent cache only, "
                             f"not {serving}")
        dcfg = DeepseekV2Config.from_dict(cfg)
        m = cfg["mapper"]
        self.ccfg = MistralCaptionConfig(prefix_length=m["prefix_length"],
                                         prefix_size=m["sizes"][0], mapping_type="mlp",
                                         islang=len(serving["tag_ids"]), mistral=dcfg)
        self.device = torch.device(device)
        mapper = make_mapper("mlp", m["sizes"][0], dcfg.hidden_size, m["prefix_length"],
                             device=self.device)
        with torch.no_grad():
            for lin, p in zip(mapper.layers, weights["mapper"]):
                lin.weight.copy_(p["w"].t())
                lin.bias.copy_(p["b"])
        dtype = getattr(torch, serving["activations"])
        base = {"embed": weights["embed"].to(dtype), "norm": weights["norm"].to(dtype),
                "lm_head": weights["lm_head"].to(dtype),
                "layers": [_cast(lp, dtype) for lp in weights["layers"]]}
        self.params = {"mapper": mapper, "mistral": prepare_deepseek_v2(base, dcfg)}
        self.tags = torch.tensor(serving["tag_ids"], dtype=torch.int64, device=self.device)
        self.eos = serving["eos_token_id"]
        self.new_tokens = serving["new_tokens"]
        prompt = m["prefix_length"] + len(serving["tag_ids"])
        self.graphs = StepGraphs(self.params["mistral"], dcfg, batch, prompt + self.new_tokens,
                                 dtype, self.device)

    def caption(self, prefix):
        """``prefix`` [B, prefix_size] float32 numpy -> (tokens [B, new_tokens]
        int64, lengths [B] int64), numpy."""
        from zs_aac_tpu_torch.decoding.greedy import deepseek_greedy_decode
        from zs_aac_tpu_torch.models.caption_mistral import mistral_caption_embeddings

        with torch.no_grad():
            x = torch.from_numpy(prefix).to(self.device)
            tags = self.tags[None].expand(x.shape[0], -1)
            emb = mistral_caption_embeddings(self.params, self.ccfg, x, None, tags)
            toks, lens = deepseek_greedy_decode(self.params["mistral"], self.ccfg.mistral, emb,
                                                self.new_tokens, self.eos, self.graphs)
        return toks.cpu().numpy(), lens.cpu().numpy()


def _cast(tree, dtype):
    """Every leaf in ``dtype``: the bf16 weights pass as they are (no copy),
    the float32 RMSNorm scales are cast."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)
