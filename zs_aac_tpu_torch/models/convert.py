"""Weight bridge: JAX-package parameter trees -> the port's parameters.

``from_jax_params(tree)`` takes a parameter tree as the JAX package holds it
(nested dicts and lists of numpy arrays; a tree read from a ``best.pth``
checkpoint, whose lists are dicts keyed "0", "1", ..., works too) and
returns the port's parameters on ``device``:

- a GPT-2 tree (float, or quantized by ``quantize_gpt2_int8``) -> the dict of
  tensors ``models.gpt2`` takes (the int8 lm-head padded as it pads it);
- a mapper tree (flax ``Dense`` kernels ``[in, out]``) -> an ``MLP`` or
  ``TransformerMapper`` module with the weights loaded;
- a caption-model tree {"mapper", "gpt2", ["sound_effect"],
  ["cross_attention"]} -> {"mapper": module, "gpt2": dict, ["sound_effect":
  MLP], ["cross_attention": module]};
- a Mistral captioner tree {"mapper", "lora", ["mistral"]} (a ``best.pth``
  holds the first two) -> {"mapper": module, "lora": dict, ["mistral":
  dict]}: LoRA's lists of layers and its 0-d ``r``/``alpha`` leaves, the
  base float or int8 (``{"w", "scale"|"scale_a8"}`` leaves, laid out and
  the ``lm_head`` padded as ``models.mistral`` does); a Mistral tree alone
  {"embed", "layers", "norm", "lm_head"} likewise;
- a variable tree ``{"params", "batch_stats"}`` (ASE, HTSAT, BERT) -> the same
  tree of tensors: the port keeps the JAX layouts (flax Dense ``[in, out]``,
  conv HWIO, LayerNorm ``scale``/``bias``, BatchNorm ``mean``/``var``).

``to_jax_params(params)`` is the inverse for caption models and their parts:
the port's modules and dicts of tensors back to the JAX package's layout, as
numpy copies in nested dicts (lists keyed "0", "1", ..., as flax's
``to_state_dict`` writes them), ready for ``utils.checkpoints.save_params``;
a Mistral base's int8 ``lm_head`` is cut back to the vocabulary.

``convert_cnn``, ``convert_resnet38``, ``convert_htsat`` and ``convert_ase``
read the reference PyTorch layouts (the PANNs towers' and the HTSAT tower's
state dicts, and the full CLAP checkpoint, ``HTSAT-BERT-ZS.pt``) into those
trees, as the JAX package's converters of the same names do.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

from zs_aac_tpu_torch.models.caption import SoundEffectCrossAttention
from zs_aac_tpu_torch.models.gpt2 import _pad_wte_q
from zs_aac_tpu_torch.models.mapper import MLP, TransformerMapper
from zs_aac_tpu_torch.utils.device import resolve_device

__all__ = ["from_jax_params", "to_jax_params", "tree_map", "cast_floating", "state_dict_tensors",
           "linear_kernel", "convert_cnn", "convert_resnet38", "convert_htsat", "convert_ase"]


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
    if isinstance(a, torch.Tensor):      # a bfloat16 leaf read as a tensor
        return a.to(device)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _gpt2(tree, device):
    p = tree_map(lambda a: _to_tensor(a, device), tree)
    if "wte_q" in p:
        q = p["wte_q"]
        skey = "scale_a8" if "scale_a8" in q else "scale"
        q["w"], q[skey] = _pad_wte_q(q["w"], q[skey])
    return p


def _mistral(tree, device):
    from zs_aac_tpu_torch.models.mistral import _pad_cols, col_major

    p = tree_map(lambda a: _to_tensor(a, device), tree)
    head = p["lm_head"]
    if isinstance(head, dict):
        skey = "scale_a8" if "scale_a8" in head else "scale"
        head["w"], head[skey] = _pad_cols(head["w"], head[skey])
    for leaf in [head] + [site for layer in p["layers"] for part in ("attn", "mlp")
                          for site in layer[part].values()]:
        if isinstance(leaf, dict):
            leaf["w"] = col_major(leaf["w"])
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


def _cross_attention(tree, device):
    dim = np.asarray(tree["q_proj"]["kernel"]).shape[0]
    module = SoundEffectCrossAttention(dim, device=device)
    sd = {}
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _linear(sd, name, tree[name], device)
    module.load_state_dict(sd)
    return module


def from_jax_params(tree, device="cuda"):
    """JAX-package parameter tree (numpy leaves) -> port parameters."""
    dev = resolve_device(device)
    if "params" in tree:
        return tree_map(lambda a: _to_tensor(a, dev), tree)
    tree = _listify(tree)
    if "gpt2" in tree and "mapper" in tree:
        out = {"mapper": _mapper(tree["mapper"], dev), "gpt2": _gpt2(tree["gpt2"], dev)}
        if "sound_effect" in tree:
            out["sound_effect"] = _mapper(tree["sound_effect"], dev)
        if "cross_attention" in tree:
            out["cross_attention"] = _cross_attention(tree["cross_attention"], dev)
        return out
    if "lora" in tree and "mapper" in tree:
        out = {"mapper": _mapper(tree["mapper"], dev),
               "lora": tree_map(lambda a: _to_tensor(a, dev), tree["lora"])}
        if "mistral" in tree:
            out["mistral"] = _mistral(tree["mistral"], dev)
        return out
    if "wte" in tree and "h" in tree:
        return _gpt2(tree, dev)
    if "embed" in tree and "layers" in tree:
        return _mistral(tree, dev)
    return _mapper(tree, dev)


def _host(t) -> np.ndarray:
    """A numpy copy of a tensor or array (never a view of its storage)."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", copy=True).numpy()
    return np.array(t)


def _dense(lin: nn.Linear) -> dict:
    out = {"kernel": _host(lin.weight).T.copy()}
    if lin.bias is not None:
        out["bias"] = _host(lin.bias)
    return out


def _module_tree(module: nn.Module) -> dict:
    """A port module's parameters under the names the JAX modules use."""
    if isinstance(module, MLP):
        return {f"fc{i}": _dense(lin) for i, lin in enumerate(module.layers)}
    if isinstance(module, TransformerMapper):
        out = {"linear": _dense(module.linear), "prefix_const": _host(module.prefix_const)}
        for i, layer in enumerate(module.layers):
            ln = lambda m: {"scale": _host(m.weight), "bias": _host(m.bias)}
            out[f"layer{i}"] = {
                "norm1": ln(layer.norm1),
                "attn": {n: _dense(getattr(layer.attn, n))
                         for n in ("to_queries", "to_keys_values", "project")},
                "norm2": ln(layer.norm2), "fc1": _dense(layer.fc1), "fc2": _dense(layer.fc2)}
        return out
    if isinstance(module, SoundEffectCrossAttention):
        return {n: _dense(getattr(module, n)) for n in ("q_proj", "k_proj", "v_proj", "out_proj")}
    raise TypeError(f"no JAX layout for {type(module).__name__}")


def to_jax_params(params):
    """Port parameters (a caption model, a mapper, a GPT-2 dict, or any tree
    of them) -> the JAX package's parameter tree of numpy copies, lists as
    dicts keyed "0", "1", ... (flax's state dict)."""
    if isinstance(params, nn.Module):
        return _module_tree(params)
    if isinstance(params, dict) and "embed" in params and isinstance(params.get("lm_head"), dict):
        V = params["embed"].shape[0]
        out = {k: to_jax_params(v) for k, v in params.items()}
        out["lm_head"] = {k: v[..., :V] for k, v in out["lm_head"].items()}
        return out
    if isinstance(params, dict):
        return {k: to_jax_params(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return {str(i): to_jax_params(v) for i, v in enumerate(params)}
    return _host(params)


def state_dict_tensors(state_dict: Mapping, device) -> dict:
    """A torch (or numpy) state dict as tensors on ``device``, floats fp32."""
    out = {}
    for k, v in state_dict.items():
        t = v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        out[k] = t.to(device=device, dtype=torch.float32 if t.is_floating_point() else t.dtype)
    return out


def linear_kernel(w: torch.Tensor) -> torch.Tensor:
    """torch ``Linear`` weight ``[out, in]`` -> a Dense kernel ``[in, out]``."""
    return w.t().contiguous()


class _Tree:
    """``{"params", "batch_stats"}`` filled from a reference state dict
    (tensors on the device, floats fp32): conv weights OIHW -> HWIO,
    BatchNorm weight/bias -> scale/bias, running mean/var -> batch_stats."""

    def __init__(self, state_dict: Mapping, device):
        self.sd = state_dict_tensors(state_dict, resolve_device(device))
        self.params, self.stats = {}, {}

    @staticmethod
    def _node(tree, path):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        return tree

    def conv(self, path, src):
        self._node(self.params, path)[path[-1]] = {
            "kernel": self.sd[src + ".weight"].permute(2, 3, 1, 0).contiguous()}

    def bn(self, path, src):
        sd = self.sd
        self._node(self.params, path)[path[-1]] = {"scale": sd[src + ".weight"],
                                                   "bias": sd[src + ".bias"]}
        self._node(self.stats, path)[path[-1]] = {"mean": sd[src + ".running_mean"],
                                                  "var": sd[src + ".running_var"]}

    def conv_block(self, name, src):
        for i in (1, 2):
            self.conv((name, f"conv{i}"), f"{src}.conv{i}")
            self.bn((name, f"bn{i}"), f"{src}.bn{i}")

    def variables(self):
        return {"params": self.params, "batch_stats": self.stats}


def convert_cnn(state_dict: Mapping, n_blocks: int, device="cuda") -> dict:
    """PANNs Cnn10 (``n_blocks`` 4) / Cnn14 (6) state dict -> variables for
    ``models.cnns.Cnn10``/``Cnn14``: only the ``bn0`` and ``conv_block{i}``
    keys are read (the ``fc`` head and the spectrogram/log-mel extractors are
    skipped, as the reference's loader skips them)."""
    t = _Tree(state_dict, device)
    t.bn(("bn0",), "bn0")
    for i in range(1, n_blocks + 1):
        t.conv_block(f"conv_block{i}", f"conv_block{i}")
    return t.variables()


def convert_resnet38(state_dict: Mapping, layers=(3, 4, 6, 3), device="cuda") -> dict:
    """PANNs ResNet38 state dict -> variables for ``models.cnns.ResNet38``.
    A block's downsample Sequential is ``(conv, bn)`` at ``(0, 1)`` for
    stride 1 and ``(AvgPool, conv, bn)``, so ``(1, 2)``, for stride 2."""
    t = _Tree(state_dict, device)
    t.bn(("bn0",), "bn0")
    t.conv_block("conv_block1", "conv_block1")
    t.conv_block("conv_block_after1", "conv_block_after1")
    for stage, blocks in enumerate(layers):
        for b in range(blocks):
            src, dst = f"resnet.layer{stage + 1}.{b}", f"layer{stage + 1}_block{b}"
            for i in (1, 2):
                t.conv((dst, f"conv{i}"), f"{src}.conv{i}")
                t.bn((dst, f"bn{i}"), f"{src}.bn{i}")
            for ci, bi in ((0, 1), (1, 2)):
                w = t.sd.get(f"{src}.downsample.{ci}.weight")
                if w is not None and w.dim() == 4:
                    t.conv((dst, "ds_conv"), f"{src}.downsample.{ci}")
                    t.bn((dst, "ds_bn"), f"{src}.downsample.{bi}")
                    break
    return t.variables()


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
    ``models.ase.ASE`` variables. ``cfg`` is an ``ASEConfig``; the audio
    tower is HTSAT, ResNet38 or Cnn14 (``len(cfg.audio_channels)`` blocks,
    else 6), the text tower a CLIP (``CLIPTextModel`` layout), GPT-2
    (``GPT2Model`` layout) or BERT-family one, as the JAX ``convert_ase``
    picks it."""
    from zs_aac_tpu_torch.models.ase import CLIP_TEXT_REGISTRY, GPT2_TEXT_REGISTRY, text_config
    from zs_aac_tpu_torch.models.bert import convert_bert
    from zs_aac_tpu_torch.models.text_towers import (CLIPTextConfig, GPT2EncoderConfig,
                                                     convert_clip_text, convert_gpt2_encoder)

    dev = resolve_device(device)

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}

    audio_sd = sub("audio_encoder.audio_enc.")
    if cfg.audio_encoder == "htsat":
        audio = convert_htsat(audio_sd, device=dev)
    elif cfg.audio_encoder == "resnet38":
        audio = convert_resnet38(audio_sd, device=dev)
    else:
        n_blocks = len(cfg.audio_channels) if cfg.audio_channels else 6
        audio = convert_cnn(audio_sd, n_blocks=n_blocks, device=dev)
    text_sd = sub("text_encoder.text_encoder.")
    if cfg.text_model in CLIP_TEXT_REGISTRY:
        text = convert_clip_text(text_sd, CLIPTextConfig(**CLIP_TEXT_REGISTRY[cfg.text_model]),
                                 device=dev)
    elif cfg.text_model in GPT2_TEXT_REGISTRY:
        text = convert_gpt2_encoder(
            text_sd, GPT2EncoderConfig(**GPT2_TEXT_REGISTRY[cfg.text_model]), device=dev)
    else:
        text = convert_bert(text_sd, text_config(cfg.text_model), device=dev)
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
