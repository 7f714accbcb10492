"""Checkpoints: the port's train states, and the JAX package's parameter
snapshots.

Train states (``save_train_state``, ``restore_train_state``,
``restore_model_only``) are the port's own format: one ``torch.save`` file
of ``{"params", "batch_stats", "opt_state", "step"}`` (CPU tensors in plain
dicts and tuples, read back with ``weights_only=True``), with the JAX
package's semantics: a full restore resumes params, optimizer and step; a
model-only restore warm-starts params and batch statistics and keeps the
fresh optimizer (the reference's ``pretrain_path`` load). The JAX package's
orbax train-state directories are not read. ``load_ase_variables`` reads an
ASE for inference from a train state or from a reference-layout checkpoint.

The JAX package's ``best.pth`` / ``last.pth`` parameter snapshots (flax
``serialization.to_bytes``: msgpack) are read without flax or msgpack.

flax writes the state dict as msgpack maps (lists become maps keyed "0",
"1", ...), arrays as ext type 1 holding a msgpack ``(shape, dtype name,
C-order bytes)`` triple and numpy scalars as ext type 3. ``load_params(path)``
returns the nested dict with numpy leaves, ready for
``models.convert.from_jax_params``. bfloat16 leaves are widened to float32,
which is exact. (flax splits arrays over 1 GiB into chunked maps; no
checkpoint of this slice's models has one, and such a leaf stays a map.)
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np
import torch

__all__ = ["msgpack_unpackb", "load_params", "save_train_state", "restore_train_state",
           "restore_model_only", "load_ase_variables"]


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_cpu(v) for v in tree)
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def _like(template, loaded):
    """``loaded`` with each tensor moved to the device of the template's
    tensor at the same place (and the template's container types)."""
    if isinstance(template, dict):
        return {k: _like(template[k], loaded[k]) for k in template}
    if isinstance(template, (tuple, list)):
        return type(template)(_like(t, v) for t, v in zip(template, loaded))
    if isinstance(template, torch.Tensor):
        return loaded.to(template.device)
    return loaded


def save_train_state(path: str, state) -> None:
    """The whole train state to one file (written to a temporary name, then
    renamed, so a reader never sees half a checkpoint)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"params": _cpu(state.params), "batch_stats": _cpu(state.batch_stats),
               "opt_state": _cpu(state.opt_state), "step": int(state.step)}
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_train_state(path: str, template):
    """Full resume: params, batch stats, optimizer state and step, placed as
    in ``template``."""
    payload = _load(path)
    return dataclasses.replace(
        template, params=_like(template.params, payload["params"]),
        batch_stats=_like(template.batch_stats, payload["batch_stats"]),
        opt_state=_like(template.opt_state, payload["opt_state"]), step=payload["step"])


def restore_model_only(path: str, template):
    """Warm start: params and batch stats from ``path``; the template's
    (fresh) optimizer state and step stay."""
    payload = _load(path)
    return dataclasses.replace(
        template, params=_like(template.params, payload["params"]),
        batch_stats=_like(template.batch_stats, payload["batch_stats"]))


def load_ase_variables(path: str, cfg, device="cuda") -> dict:
    """``models.ase.ASE`` variables ``{"params", "batch_stats"}`` on ``device``
    from either file an ASE is kept in: a train state written by
    ``save_train_state`` (its params and batch statistics, what
    ``restore_model_only`` takes; the optimizer state and step are dropped), or
    a reference-layout checkpoint (``HTSAT-BERT-ZS.pt``, bare or under
    ``"model"``), converted by ``models.convert.convert_ase`` for the
    ``ASEConfig`` ``cfg``."""
    from zs_aac_tpu_torch.models.convert import convert_ase, tree_map
    from zs_aac_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    payload = _load(path)
    if "params" in payload and "batch_stats" in payload:
        return tree_map(lambda t: t.to(dev),
                        {"params": payload["params"], "batch_stats": payload["batch_stats"]})
    return convert_ase(payload.get("model", payload), cfg, device=dev)


_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buf = msgpack_unpackb(data)
    if isinstance(buf, str):
        buf = buf.encode("latin-1")
    if dtype_name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"unknown msgpack ext type {code}")


class _Reader:
    def __init__(self, data: bytes):
        self.b = memoryview(data)
        self.i = 0

    def take(self, n: int) -> bytes:
        out = self.b[self.i:self.i + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.i += n
        return bytes(out)

    def fmt(self, f: str):
        n = struct.calcsize(f)
        return struct.unpack(f, self.take(n))[0]

    def obj(self):
        t = self.fmt(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.take(t & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}         # bin
        if t in sized:
            return self.take(self.fmt(sized[t]))
        sized = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}         # str
        if t in sized:
            return self.take(self.fmt(sized[t])).decode("utf-8")
        sized = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}         # ext
        if t in sized:
            n = self.fmt(sized[t])
            code = self.fmt(">b")
            return _ext(code, self.take(n))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            code = self.fmt(">b")
            return _ext(code, self.take(fixext[t]))
        scalar = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                  0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in scalar:
            return self.fmt(scalar[t])
        if t in (0xDC, 0xDD):
            return self.array(self.fmt(">H" if t == 0xDC else ">I"))
        if t in (0xDE, 0xDF):
            return self.map(self.fmt(">H" if t == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def array(self, n: int):
        return [self.obj() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def msgpack_unpackb(data: bytes):
    """Decode one msgpack object (the subset flax's checkpoints use)."""
    r = _Reader(data)
    obj = r.obj()
    if r.i != len(r.b):
        raise ValueError("trailing bytes after the msgpack object")
    return obj


def load_params(path: str):
    """A ``save_params`` snapshot -> nested dict of numpy arrays."""
    with open(path, "rb") as f:
        return msgpack_unpackb(f.read())
