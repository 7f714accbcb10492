"""Checkpoints: the port's train states, and the JAX package's parameter
snapshots.

Train states (``save_train_state``, ``restore_train_state``,
``restore_model_only``) are the port's own format: one ``torch.save`` file
of ``{"params", "batch_stats", "opt_state", "step"}`` (CPU tensors in plain
dicts and tuples, read back with ``weights_only=True``), with the JAX
package's semantics: a full restore resumes params, optimizer and step; a
model-only restore warm-starts params and batch statistics and keeps the
fresh optimizer (the reference's ``pretrain_path`` load). The JAX package's
orbax train-state directories are not read here (orbax's reader needs
tensorstore): ``examples/convert_jax_state.py``, run where the JAX package
runs, converts one into this format, and every reader here given a
directory raises a ``ValueError`` naming that command. ``load_ase_variables``
reads an ASE for inference from a train state or from a reference-layout
checkpoint.

The JAX package's ``best.pth`` / ``last.pth`` parameter snapshots (flax
``serialization.to_bytes``: msgpack) are read and written without flax or
msgpack: ``load_params`` reads either package's, ``save_params`` writes the
bytes flax writes for the same tree, so the JAX package's ``load_params(path,
template)`` restores it. ``save_params_async`` copies every leaf to host
memory before it returns (the optimizer updates the port's parameters in
place) and writes in a thread; ``join_async_saves`` waits for the writes.

flax writes the state dict as msgpack maps (lists become maps keyed "0",
"1", ...), arrays as ext type 1 holding a msgpack ``(shape, dtype name,
C-order bytes)`` triple and numpy scalars as ext type 3. ``load_params(path)``
returns the nested dict with numpy leaves, ready for
``models.convert.from_jax_params``. bfloat16 leaves are widened to float32,
which is exact, or with ``bf16_tensors=True`` come back as CPU
``torch.bfloat16`` tensors (flax restores a leaf in its stored dtype, so a
driver that serves a checkpoint in its dtype needs to know it). (flax splits arrays over 1 GiB into chunked maps; no
checkpoint of this slice's models has one, and such a leaf stays a map.)
"""

from __future__ import annotations

import dataclasses
import os
import struct
import threading

import numpy as np
import torch

from zs_aac_tpu_torch.models.convert import to_jax_params

__all__ = ["msgpack_unpackb", "msgpack_packb", "load_params", "save_params",
           "save_params_async", "join_async_saves", "criterion_improver", "save_train_state", "restore_train_state",
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
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory: a JAX-package orbax train state, which the "
                         "port does not read. Convert it where the JAX package runs: python "
                         f"examples/convert_jax_state.py -c CONFIG.yaml --orbax_dir {path} "
                         "--out FILE, and pass FILE")
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


def _ndarray(data: bytes, bf16_tensors: bool = False):
    shape, dtype_name, buf = msgpack_unpackb(data)
    if isinstance(buf, str):
        buf = buf.encode("latin-1")
    if dtype_name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16)
        if bf16_tensors:
            return torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16).reshape(shape)
        return (bits.astype(np.uint32) << 16).view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def _ext(code: int, data: bytes, bf16_tensors: bool = False):
    if code == _EXT_NDARRAY:
        return _ndarray(data, bf16_tensors)
    if code == _EXT_NPSCALAR:
        return _ndarray(data, bf16_tensors)[()]
    raise ValueError(f"unknown msgpack ext type {code}")


class _Reader:
    def __init__(self, data: bytes, bf16_tensors: bool = False):
        self.b = memoryview(data)
        self.i = 0
        self.bf16_tensors = bf16_tensors

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
            return _ext(code, self.take(n), self.bf16_tensors)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            code = self.fmt(">b")
            return _ext(code, self.take(fixext[t]), self.bf16_tensors)
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


def msgpack_unpackb(data: bytes, bf16_tensors: bool = False):
    """Decode one msgpack object (the subset flax's checkpoints use)."""
    r = _Reader(data, bf16_tensors)
    obj = r.obj()
    if r.i != len(r.b):
        raise ValueError("trailing bytes after the msgpack object")
    return obj


def load_params(path: str, bf16_tensors: bool = False):
    """A ``save_params`` snapshot -> nested dict of numpy arrays (bfloat16
    leaves as ``torch.bfloat16`` tensors with ``bf16_tensors``)."""
    with open(path, "rb") as f:
        return msgpack_unpackb(f.read(), bf16_tensors)


def _pack_ext(out: list, code: int, data: bytes) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(struct.pack(">Bb", fixext[n], code))
    elif n < 1 << 8:
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n < 1 << 16:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    out.append(data)


def _pack_len(out: list, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, else 8/16/32-bit
    (``codes`` has None where msgpack has no 8-bit form)."""
    if n < fix_max:
        out.append(struct.pack(">B", fix | n))
    elif codes[0] is not None and n < 1 << 8:
        out.append(struct.pack(">BB", codes[0], n))
    elif n < 1 << 16:
        out.append(struct.pack(">BH", codes[1], n))
    else:
        out.append(struct.pack(">BI", codes[2], n))


def _pack_int(out: list, x: int) -> None:
    if 0 <= x <= 0x7F or -32 <= x < 0:
        out.append(struct.pack(">b" if x < 0 else ">B", x))
    elif x >= 0:
        for code, fmt, hi in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                              (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if x < hi:
                out.append(struct.pack(">B", code) + struct.pack(fmt, x))
                return
        raise OverflowError(x)
    else:
        for code, fmt, lo in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                              (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if x >= lo:
                out.append(struct.pack(">B", code) + struct.pack(fmt, x))
                return
        raise OverflowError(x)


def _ndarray_bytes(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be written")
    return msgpack_packb((a.shape, a.dtype.name, a.tobytes("C")))


def _pack(out: list, obj) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), 0, 0, (0xC4, 0xC5, 0xC6))
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot write {type(obj).__name__} to msgpack")


def msgpack_packb(obj) -> bytes:
    """Encode ``obj`` as msgpack-python's ``packb`` does (bin type for bytes),
    numpy arrays and scalars as flax's ext types 1 and 3."""
    out: list = []
    _pack(out, obj)
    return b"".join(out)


def _write(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_params(path: str, params) -> None:
    """One msgpack snapshot of ``params`` (a port caption model or any tree
    ``models.convert.to_jax_params`` takes) in the JAX package's layout: the
    ``best.pth`` / ``last.pth`` of a captioner run dir. Written to a
    temporary name, then renamed."""
    _write(path, msgpack_packb(to_jax_params(params)))


class _Save(threading.Thread):
    """A snapshot's write; ``join`` re-raises what the write raised."""

    def __init__(self, path: str, tree):
        super().__init__()
        self.path, self.tree, self.error = path, tree, None

    def run(self):
        try:
            _write(self.path, msgpack_packb(self.tree))
        except BaseException as e:  # re-raised by join in the caller's thread
            self.error = e

    def join(self, timeout=None):
        super().join(timeout)
        if self.error is not None:
            raise self.error


_ASYNC_SAVES: dict = {}


def save_params_async(path: str, params) -> None:
    """``save_params`` with the write in a background thread. Every leaf is
    copied to host memory before this returns, so training may go on
    updating the parameters in place. Writes to the same path are
    serialized; call ``join_async_saves()`` before reading the files or
    exiting."""
    tree = to_jax_params(params)
    prev = _ASYNC_SAVES.pop(path, None)
    if prev is not None:
        prev.join()
    t = _Save(path, tree)
    t.start()
    _ASYNC_SAVES[path] = t


def join_async_saves() -> None:
    for path in list(_ASYNC_SAVES):
        _ASYNC_SAVES.pop(path).join()


def criterion_improver(mode: str):
    """A closure that says whether a value beats the best seen so far (lower
    for "loss", higher for "acc" and "score"; the first value always does)."""
    if mode not in ("loss", "acc", "score"):
        raise ValueError(f"unknown criterion mode {mode!r}")
    best = float("inf") if mode == "loss" else float("-inf")

    def inner(x: float) -> bool:
        nonlocal best
        better = x < best if mode == "loss" else x > best
        if better:
            best = x
        return better

    return inner
