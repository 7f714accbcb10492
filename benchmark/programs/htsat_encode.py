"""The system under test of the encode cells: the port's CLAP bank build as
``pipeline/extract.py::load_ase_encoders`` makes ``encode_audio.pcm``.

``train/pretrain.py::build_ase_from_config`` on the configuration's
``clap`` group (``configs/extract_data.yaml``: HTSAT, kernels K2, K3 in
stages 1-3 and K5 in stage 4 on the card), the variables cast to bf16 with
``models/convert.py::cast_floating``, then per batch: int16 PCM from the
host moved to the card, ``ops/resample.py::resample_poly_device`` to the
model's rate and length, ``train/contrastive.py::make_encode_fns``'s
``encode_audio``, float32 embeddings back on the host. The weights are the
benchmark's (``reference/<config>.py::make_clap_weights``).
"""

from __future__ import annotations

import torch

KERNELS = ("logmel", "window_attn")


def counters() -> dict:
    from zs_aac_tpu_torch.ops.logmel import log_mel
    from zs_aac_tpu_torch.ops.window_attn import fused_swin_block, fused_window_attention

    return {"K2.launches": log_mel.launches, "K2.fast_launches": log_mel.fast_launches,
            "K3.launches": fused_swin_block.launches,
            "K3.tc_launches": fused_swin_block.tc_launches,
            "K5.launches": fused_window_attention.launches,
            "K5.tc_launches": fused_window_attention.tc_launches}


class Encoder:
    def __init__(self, weights: dict, clap: dict, device, pcm_sr: int):
        from zs_aac_tpu_torch.models.convert import cast_floating
        from zs_aac_tpu_torch.ops.logmel import LogMelConfig
        from zs_aac_tpu_torch.train.contrastive import make_encode_fns
        from zs_aac_tpu_torch.train.pretrain import build_ase_from_config

        self.device = torch.device(device)
        ase, cfg = build_ase_from_config(clap, device=self.device)
        h, enc = clap["htsat"], ase.audio_enc
        got = dict(spec_size=enc.spec_size, patch_size=enc.patch_size, embed_dim=enc.embed_dim,
                   depths=list(enc.depths), num_heads=list(enc.num_heads),
                   window_size=enc.window_size, mlp_ratio=enc.mlp_ratio)
        if got != h:
            raise ValueError(f"the port's HTSAT is {got}, the configuration states {h}")
        self.variables = (cast_floating(weights, torch.bfloat16) if cfg.dtype == torch.bfloat16
                          else weights)
        self.mel_cfg = LogMelConfig.from_dict(clap["audio_args"])
        self.encode_audio = make_encode_fns(ase, self.mel_cfg, device=self.device)[0]
        self.pcm_sr = pcm_sr
        self.target_len = clap["audio_args"]["max_length"] * self.mel_cfg.sr

    def encode(self, pcm):
        """int16 PCM [B, T] numpy at ``pcm_sr`` -> float32 embeddings [B, E] numpy."""
        from zs_aac_tpu_torch.ops.resample import resample_poly_device

        waves = resample_poly_device(torch.from_numpy(pcm).to(self.device), self.pcm_sr,
                                     self.mel_cfg.sr, self.target_len)
        return self.encode_audio(self.variables, waves).float().cpu().numpy()
