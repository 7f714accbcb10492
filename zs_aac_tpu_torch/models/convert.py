"""Weight bridge: JAX-package parameter trees -> the port's parameters.

``from_jax_params(tree)`` takes a parameter tree as the JAX package holds it
(nested dicts and lists of numpy arrays; a tree read from a ``best.pth``
checkpoint, whose lists are dicts keyed "0", "1", ..., works too) and
returns the port's parameters on ``device``:

- a GPT-2 tree (float, or quantized by ``quantize_gpt2_int8``) -> the dict of
  tensors ``models.gpt2`` takes (the int8 lm-head padded as it pads it);
- a mapper tree (flax ``Dense`` kernels ``[in, out]``) -> an ``MLP`` or
  ``TransformerMapper`` module with the weights loaded;
- a caption-model tree {"mapper", "gpt2"} -> {"mapper": module, "gpt2": dict};
- a variable tree ``{"params", "batch_stats"}`` (ASE, HTSAT, BERT) -> the same
  tree of tensors: the port keeps the JAX layouts (flax Dense ``[in, out]``,
  conv HWIO, LayerNorm ``scale``/``bias``, BatchNorm ``mean``/``var``).

``convert_htsat`` and ``convert_ase`` read the reference PyTorch layouts (the
HTSAT tower's state dict and the full CLAP checkpoint, ``HTSAT-BERT-ZS.pt``)
into those trees, as the JAX package's converters of the same names do.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from zs_aac_tpu_torch.models.gpt2 import _pad_wte_q
from zs_aac_tpu_torch.models.mapper import MLP, TransformerMapper
from zs_aac_tpu_torch.utils.device import resolve_device

__all__ = ["from_jax_params", "tree_map", "cast_floating", "state_dict_tensors",
           "convert_htsat", "convert_ase"]


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def cast_floating(tree, dtype):
    """Cast the floating-point tensors of a parameter dict to ``dtype``."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


def _listify(tree):
    """Checkpoint dicts keyed "0".."n-1" back into lists."""
    if isinstance(tree, dict):
        out = {k: _listify(v) for k, v in tree.items()}
        if out and all(isinstance(k, str) and k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out
    if isinstance(tree, (list, tuple)):
        return [_listify(v) for v in tree]
    return tree


def _to_tensor(a, device):
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _gpt2(tree, device):
    p = tree_map(lambda a: _to_tensor(a, device), tree)
    if "wte_q" in p:
        q = p["wte_q"]
        skey = "scale_a8" if "scale_a8" in q else "scale"
        q["w"], q[skey] = _pad_wte_q(q["w"], q[skey])
    return p


def _linear(sd, dst, src, device):
    sd[dst + ".weight"] = _to_tensor(np.asarray(src["kernel"]).T, device)
    if "bias" in src:
        sd[dst + ".bias"] = _to_tensor(src["bias"], device)


def _mapper(tree, device):
    sd = {}
    if "fc0" in tree:
        n = sum(1 for k in tree if k.startswith("fc"))
        sizes = [np.asarray(tree["fc0"]["kernel"]).shape[0]] + [
            np.asarray(tree[f"fc{i}"]["kernel"]).shape[1] for i in range(n)]
        module = MLP(sizes, use_bias="bias" in tree["fc0"], device=device)
        for i in range(n):
            _linear(sd, f"layers.{i}", tree[f"fc{i}"], device)
    elif "prefix_const" in tree:
        prefix_length, D = np.asarray(tree["prefix_const"]).shape
        dim_clip, out = np.asarray(tree["linear"]["kernel"]).shape
        n = sum(1 for k in tree if k.startswith("layer"))
        module = TransformerMapper(dim_clip, D, prefix_length, out // D, n, device=device)
        _linear(sd, "linear", tree["linear"], device)
        sd["prefix_const"] = _to_tensor(tree["prefix_const"], device)
        for i in range(n):
            src, dst = tree[f"layer{i}"], f"layers.{i}"
            for ln in ("norm1", "norm2"):
                sd[f"{dst}.{ln}.weight"] = _to_tensor(src[ln]["scale"], device)
                sd[f"{dst}.{ln}.bias"] = _to_tensor(src[ln]["bias"], device)
            for lin in ("to_queries", "to_keys_values", "project"):
                _linear(sd, f"{dst}.attn.{lin}", src["attn"][lin], device)
            for lin in ("fc1", "fc2"):
                _linear(sd, f"{dst}.{lin}", src[lin], device)
    else:
        raise ValueError(f"not a mapper tree: keys {sorted(tree)}")
    module.load_state_dict(sd)
    return module


def from_jax_params(tree, device="cuda"):
    """JAX-package parameter tree (numpy leaves) -> port parameters."""
    dev = resolve_device(device)
    if "params" in tree:
        return tree_map(lambda a: _to_tensor(a, dev), tree)
    tree = _listify(tree)
    if "gpt2" in tree and "mapper" in tree:
        return {"mapper": _mapper(tree["mapper"], dev), "gpt2": _gpt2(tree["gpt2"], dev)}
    if "wte" in tree and "h" in tree:
        return _gpt2(tree, dev)
    return _mapper(tree, dev)


def state_dict_tensors(state_dict: Mapping, device) -> dict:
    """A torch (or numpy) state dict as tensors on ``device``, floats fp32."""
    out = {}
    for k, v in state_dict.items():
        t = v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        out[k] = t.to(device=device, dtype=torch.float32 if t.is_floating_point() else t.dtype)
    return out


def convert_htsat(state_dict: Mapping, depths=None, device="cuda") -> dict:
    """HTSAT state dict (the reference's layer names: ``bn0``,
    ``patch_embed.{proj,norm}``, ``layers.{i}.blocks.{j}.*``,
    ``layers.{i}.downsample.*``, ``norm``, ``tscam_conv``) -> ``{"params",
    "batch_stats"}`` for ``models.htsat.HTSAT``. ``depths`` defaults to the
    ``layers.{i}.blocks.{j}`` keys found; the spectrogram extractors and the
    unused ``head`` are ignored."""
    dev = resolve_device(device)
    sd = state_dict_tensors(state_dict, dev)
    if depths is None:
        found = {}
        for k in sd:
            m = re.match(r"layers\.(\d+)\.blocks\.(\d+)\.", k)
            if m:
                i, j = int(m.group(1)), int(m.group(2))
                found[i] = max(found.get(i, 0), j + 1)
        depths = tuple(found[i] for i in sorted(found))

    def ln(src):
        return {"scale": sd[src + ".weight"], "bias": sd[src + ".bias"]}

    def dense(src, bias=True):
        p = {"kernel": sd[src + ".weight"].t().contiguous()}
        if bias and src + ".bias" in sd:
            p["bias"] = sd[src + ".bias"]
        return p

    def conv(src):
        p = {"kernel": sd[src + ".weight"].permute(2, 3, 1, 0).contiguous()}  # OIHW -> HWIO
        if src + ".bias" in sd:
            p["bias"] = sd[src + ".bias"]
        return p

    params = {"bn0": ln("bn0"), "patch_proj": conv("patch_embed.proj"),
              "patch_norm": ln("patch_embed.norm")}
    for i, depth in enumerate(depths):
        for j in range(depth):
            src = f"layers.{i}.blocks.{j}"
            params[f"layer{i}_block{j}"] = {
                "norm1": ln(f"{src}.norm1"), "norm2": ln(f"{src}.norm2"),
                "attn": {"qkv": dense(f"{src}.attn.qkv"), "proj": dense(f"{src}.attn.proj"),
                         "rpb_table": sd[f"{src}.attn.relative_position_bias_table"]},
                "fc1": dense(f"{src}.mlp.fc1"), "fc2": dense(f"{src}.mlp.fc2"),
            }
        if i < len(depths) - 1:
            params[f"downsample{i}"] = {
                "norm": ln(f"layers.{i}.downsample.norm"),
                "reduction": dense(f"layers.{i}.downsample.reduction", bias=False)}
    params["norm"] = ln("norm")
    params["tscam_conv"] = conv("tscam_conv")
    stats = {"bn0": {"mean": sd["bn0.running_mean"], "var": sd["bn0.running_var"]}}
    return {"params": params, "batch_stats": stats}


def convert_ase(state_dict: Mapping, cfg, device="cuda") -> dict:
    """Full CLAP checkpoint (the reference's ``HTSAT-BERT-ZS.pt`` layout:
    ``audio_encoder.audio_enc.*``, ``text_encoder.text_encoder.*``,
    ``audio_proj.{0,2}.*``, ``text_proj.{0,2}.*``, ``temp``) ->
    ``models.ase.ASE`` variables. ``cfg`` is an ``ASEConfig``; the HTSAT
    audio tower and the BERT text towers are ported."""
    from zs_aac_tpu_torch.models.ase import text_config
    from zs_aac_tpu_torch.models.bert import convert_bert

    dev = resolve_device(device)
    if cfg.audio_encoder != "htsat":
        raise NotImplementedError(
            f"audio tower {cfg.audio_encoder!r} (Cnn14/ResNet38) waits for a later slice")
    tcfg = text_config(cfg.text_model)

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}

    audio = convert_htsat(sub("audio_encoder.audio_enc."), device=dev)
    text = convert_bert(sub("text_encoder.text_encoder."), tcfg, device=dev)
    sd = state_dict_tensors({k: v for k, v in state_dict.items()
                      if k.startswith(("audio_proj.", "text_proj.")) or k == "temp"}, dev)

    def proj(prefix):
        return {"fc1": {"kernel": sd[prefix + ".0.weight"].t().contiguous(),
                        "bias": sd[prefix + ".0.bias"]},
                "fc2": {"kernel": sd[prefix + ".2.weight"].t().contiguous(),
                        "bias": sd[prefix + ".2.bias"]}}

    params = {"audio_enc": audio["params"], "text_enc": text["params"],
              "audio_proj": proj("audio_proj"), "text_proj": proj("text_proj"),
              "temp": sd["temp"].reshape(())}
    return {"params": params, "batch_stats": {"audio_enc": audio["batch_stats"]}}
