"""The reference's checkpointer (port of ``repro.checkpoint.checkpointer``):
its layout, written and read without JAX and without ``msgpack``, which
the card's machine may lack.

A checkpoint directory holds

* ``arrays.npz``    — one array per ``/``-joined leaf path, keyed as the
  reference keys them: ``params/layers/attn/wq`` for a parameter (stacked
  over layers), ``opt/.count``, ``opt/.mu/<path>`` and ``opt/.nu/<path>``
  for an :class:`~repro_torch.optim.AdamWState` (JAX names a NamedTuple
  field ``.name``);
* ``index.msgpack`` — {"step": int, "leaves": [{"path", "shape", "dtype",
  "pspec"}, ...]}, written and read by the small msgpack codec below
  (maps, strings, integers, lists: what the index holds).

:func:`load_checkpoint` reads the payload flat; :func:`load_train_state`
restores a model and its optimizer state. Leaves saved in bfloat16 are
written as 2-byte void arrays (numpy has no bfloat16) and come back, as
the reference's own do, through
:func:`repro_torch.core.convert.reference_tensor`, bit for bit. A
checkpoint the reference wrote is read here, and one written here in
float32 is read by the reference's ``load_checkpoint``.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

INDEX = "index.msgpack"
ARRAYS = "arrays.npz"


# ---------------------------------------------------------------- msgpack
def pack(obj) -> bytes:
    """msgpack bytes of ``obj`` (dict, list/tuple, str, int), in the
    smallest encoding for each, as ``msgpack.packb`` writes them."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _head(n, out, fix, fix_max, codes):
    """A length header: the fix form below ``fix_max``, else the 8/16/32
    bit form (``codes`` maps width to its type byte)."""
    if n < fix_max:
        out.append(fix | n)
        return
    for fmt, code in codes:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack(obj, out: bytearray) -> None:
    if isinstance(obj, bool) or obj is None:
        raise TypeError(f"msgpack codec: {type(obj).__name__} not supported")
    if isinstance(obj, int):
        if 0 <= obj < 128:
            out.append(obj)
        elif -32 <= obj < 0:
            out += struct.pack(">b", obj)
        elif obj > 0:
            for fmt, code in ((">B", 0xCC), (">H", 0xCD), (">I", 0xCE),
                              (">Q", 0xCF)):
                if obj < 1 << (8 * struct.calcsize(fmt)):
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    return
            raise ValueError(f"msgpack: {obj} too large")
        else:
            for fmt, code in ((">b", 0xD0), (">h", 0xD1), (">i", 0xD2),
                              (">q", 0xD3)):
                if obj >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    return
            raise ValueError(f"msgpack: {obj} too small")
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _head(len(raw), out, 0xA0, 32, ((">B", 0xD9), (">H", 0xDA),
                                        (">I", 0xDB)))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _head(len(obj), out, 0x90, 16, ((">H", 0xDC), (">I", 0xDD)))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _head(len(obj), out, 0x80, 16, ((">H", 0xDE), (">I", 0xDF)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack codec: {type(obj).__name__} not supported")


def unpack(data: bytes):
    """The object of msgpack ``data`` (maps, strings, integers, arrays)."""
    obj, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ValueError("msgpack: trailing bytes")
    return obj


_INTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
         0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENS = {0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
         0xDC: (">H", "list"), 0xDD: (">I", "list"),
         0xDE: (">H", "map"), 0xDF: (">I", "map")}


def _unpack(buf, pos):
    b = buf[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if b in _INTS:
        fmt = _INTS[b]
        end = pos + struct.calcsize(fmt)
        return struct.unpack(fmt, buf[pos:end])[0], end
    if 0xA0 <= b < 0xC0:
        n, kind = b & 0x1F, "str"
    elif 0x90 <= b < 0xA0:
        n, kind = b & 0x0F, "list"
    elif 0x80 <= b < 0x90:
        n, kind = b & 0x0F, "map"
    elif b in _LENS:
        fmt, kind = _LENS[b]
        end = pos + struct.calcsize(fmt)
        n, pos = struct.unpack(fmt, buf[pos:end])[0], end
    else:
        raise ValueError(f"msgpack codec: type byte {b:#x} not supported")
    if kind == "str":
        return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n
    if kind == "list":
        out = []
        for _ in range(n):
            x, pos = _unpack(buf, pos)
            out.append(x)
        return out, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        out[k], pos = _unpack(buf, pos)
    return out, pos


# ------------------------------------------------------------- the layout
def _flatten(tree, prefix=""):
    """(``/``-joined path, leaf) in the reference's order: dict keys
    sorted, NamedTuple fields in order, named ``.field``. A list of
    per-layer tensors is one (stacked) leaf."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _flatten(getattr(tree, name), f"{prefix}.{name}/")
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten(tree[key], f"{prefix}{key}/")
    else:
        yield prefix[:-1], tree


def _host_array(leaf) -> np.ndarray:
    """A leaf as the numpy array the reference would save; a list of
    per-layer tensors is stacked, bfloat16 becomes a 2-byte void view."""
    if isinstance(leaf, (list, tuple)):
        leaf = torch.stack([t.detach() for t in leaf])
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == np.dtype("V2") else str(a.dtype)


def save_checkpoint(ckpt_dir: str, tree: Any, step: int = 0) -> None:
    """Write ``tree`` (nested dicts / NamedTuples of tensors, or lists of
    per-layer tensors) and ``step`` in the reference's layout (module
    doc). Arrays are gathered to the host one leaf at a time."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {}
    index = {"step": int(step), "leaves": []}
    for key, leaf in _flatten(tree):
        arr = _host_array(leaf)
        arrays[key] = arr
        index["leaves"].append({"path": key, "shape": list(arr.shape),
                                "dtype": _dtype_name(arr), "pspec": ""})
    np.savez(os.path.join(ckpt_dir, ARRAYS), **arrays)
    with open(os.path.join(ckpt_dir, INDEX), "wb") as f:
        f.write(pack(index))


def load_checkpoint(ckpt_dir: str) -> Dict[str, np.ndarray]:
    """{``/``-joined leaf path: numpy array} of a checkpoint."""
    with np.load(os.path.join(ckpt_dir, ARRAYS)) as npz:
        return {key: npz[key] for key in npz.files}


def checkpoint_step(ckpt_dir: str) -> Optional[int]:
    """The step a checkpoint was written at; None if there is none."""
    try:
        with open(os.path.join(ckpt_dir, INDEX), "rb") as f:
            return unpack(f.read())["step"]
    except FileNotFoundError:
        return None


def load_train_state(ckpt_dir: str, model) -> Tuple[Any, int]:
    """Restore a checkpoint of {"params": ..., "opt": AdamWState} (the
    reference's training checkpoint, or the port's): the parameters into
    ``model`` (their paths and shapes checked), the optimizer state onto
    the model's device. Returns (AdamWState, step)."""
    from repro_torch.core.convert import (adamw_from_reference,
                                          reference_tensor, subtree)

    flat = load_checkpoint(ckpt_dir)
    model.load_params({k: reference_tensor(v)
                       for k, v in subtree(flat, "params/").items()})
    opt = adamw_from_reference(subtree(flat, "opt/"), device=model.device)
    return opt, checkpoint_step(ckpt_dir)
