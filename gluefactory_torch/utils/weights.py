"""The committed weight blobs (``weights/*.f16.msgpack``) in PyTorch.

The blobs were written by gluefactory_tpu/scripts/export_weights.py with
flax's msgpack serializer: a map with the flat parameter dict under
``params`` (keys like ``"['params']['matcher']['input_proj']['kernel']"``),
``model_conf`` and a few meta fields. Arrays are msgpack ext type 1, whose
payload is itself a msgpack array ``(shape, dtype name, raw bytes)``.
``decode_msgpack`` reads that subset of msgpack in pure Python, so the port
needs neither flax nor the msgpack package.

``params_from_flat`` carries the flax parameter tree over to the port's
``state_dict`` names and layouts; ``load_blob_into`` does both and loads
strictly: every key of the blob must be used and every parameter filled.
"""

from __future__ import annotations

import re
import struct
from pathlib import Path

import numpy as np
import torch

_EXT_NDARRAY = 1


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, code: int, n: int):
        data = bytes(self.take(n))
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, raw = decode_msgpack(data)
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        fixed = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xC4: lambda: bytes(self.take(self.unpack(">B"))),
            0xC5: lambda: bytes(self.take(self.unpack(">H"))),
            0xC6: lambda: bytes(self.take(self.unpack(">I"))),
            0xC7: lambda: self._ext_sized(">B"),
            0xC8: lambda: self._ext_sized(">H"),
            0xC9: lambda: self._ext_sized(">I"),
            0xCA: lambda: self.unpack(">f"), 0xCB: lambda: self.unpack(">d"),
            0xCC: lambda: self.unpack(">B"), 0xCD: lambda: self.unpack(">H"),
            0xCE: lambda: self.unpack(">I"), 0xCF: lambda: self.unpack(">Q"),
            0xD0: lambda: self.unpack(">b"), 0xD1: lambda: self.unpack(">h"),
            0xD2: lambda: self.unpack(">i"), 0xD3: lambda: self.unpack(">q"),
            0xD4: lambda: self._ext_fixed(1), 0xD5: lambda: self._ext_fixed(2),
            0xD6: lambda: self._ext_fixed(4), 0xD7: lambda: self._ext_fixed(8),
            0xD8: lambda: self._ext_fixed(16),
            0xD9: lambda: str(self.take(self.unpack(">B")), "utf-8"),
            0xDA: lambda: str(self.take(self.unpack(">H")), "utf-8"),
            0xDB: lambda: str(self.take(self.unpack(">I")), "utf-8"),
            0xDC: lambda: [self.read() for _ in range(self.unpack(">H"))],
            0xDD: lambda: [self.read() for _ in range(self.unpack(">I"))],
            0xDE: lambda: self.map(self.unpack(">H")),
            0xDF: lambda: self.map(self.unpack(">I")),
        }
        if b not in fixed:
            raise ValueError(f"invalid msgpack type byte 0x{b:02x}")
        return fixed[b]()

    def _ext_sized(self, fmt: str):
        n = self.unpack(fmt)
        return self.ext(self.unpack(">b"), n)

    def _ext_fixed(self, n: int):
        return self.ext(self.unpack(">b"), n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def decode_msgpack(data: bytes):
    """Decode one msgpack object (the subset flax writes, see module doc)."""
    reader = _Reader(data)
    obj = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return obj


def load_weight_blob(path: str | Path) -> tuple[dict, dict, dict]:
    """(flat float32 params, model_conf, meta) of a committed weight blob."""
    payload = decode_msgpack(Path(path).read_bytes())
    flat = {
        k: (v.astype(np.float32) if v.dtype == np.float16 else np.array(v))
        for k, v in payload["params"].items()
    }
    meta = {k: payload[k] for k in ("experiment", "epoch", "iteration")}
    return flat, payload.get("model_conf", {}), meta


# --- flax parameter tree -> PyTorch state_dict ------------------------------

# flax module names whose PyTorch counterpart sits under another name
_RENAMES = [
    (re.compile(r"^(transformers|log_assignment|token_confidence)_(\d+)$"), r"\1.\2"),
    (re.compile(r"^ffn_0$"), "ffn.0"),
    (re.compile(r"^ffn_norm$"), "ffn.1"),
    (re.compile(r"^ffn_2$"), "ffn.3"),
    (re.compile(r"^token$"), "token.0"),
    (re.compile(r"^posenc$"), "posenc.Wr"),
]


def _flax_path(key: str) -> list[str]:
    parts = re.findall(r"\['([^']*)'\]", key)
    if not parts or "".join(f"['{p}']" for p in parts) != key:
        raise ValueError(f"not a flat flax parameter key: {key!r}")
    return parts


def _torch_name(path: list[str]) -> str:
    *modules, leaf = path
    if modules and modules[0] == "params":
        modules = modules[1:]
    names = []
    for i, m in enumerate(modules):
        # the cross block's FFN is a flax submodule named 'ffn' whose layers
        # are 'ffn_0'...; in PyTorch its Sequential already is 'ffn'
        if m == "ffn" and i + 1 < len(modules) and modules[i + 1].startswith("ffn_"):
            continue
        for pattern, repl in _RENAMES:
            m = pattern.sub(repl, m)
        names.append(m)
    if leaf == "kernel":
        leaf = "weight"
    elif leaf == "scale" and modules and modules[-1].endswith("norm"):
        leaf = "weight"  # LayerNorm scale; ChannelAffine keeps 'scale'
    return ".".join(names + [leaf])


def _qkv_rows(dim: int, heads: int) -> np.ndarray:
    """Row order of a PyTorch Wqkv (the official LightGlue layout, which
    unflattens its output as (heads, head_dim, 3)) in terms of the flax
    kernel's columns (laid out as (heads, 3, head_dim)): the inverse of
    gluefactory_tpu's lightglue.torch_weight_converter."""
    hd = dim // heads
    rows = np.empty(3 * dim, dtype=np.int64)
    for head in range(heads):
        for which in range(3):
            for d in range(hd):
                rows[head * 3 * hd + d * 3 + which] = head * 3 * hd + which * hd + d
    return rows


def params_from_flat(flat: dict, num_heads: dict[str, int] | None = None) -> dict:
    """Flat flax params -> PyTorch state_dict.

    Dense kernels (in, out) become Linear weights (out, in); conv kernels
    HWIO become OIHW. ``num_heads`` maps the module prefix of each LightGlue
    (e.g. ``"matcher"``) to its head count, which fixes the Wqkv row order.
    """
    state = {}
    for key, value in flat.items():
        path = _flax_path(key)
        name = _torch_name(path)
        arr = np.asarray(value)
        if path[-1] == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"{key}: kernel of rank {arr.ndim}")
        if "Wqkv" in path:
            prefix = name.split("transformers.")[0].rstrip(".")
            heads = (num_heads or {}).get(prefix)
            if heads is None:
                raise KeyError(f"{key}: no head count given for {prefix!r}")
            arr = arr[_qkv_rows(arr.shape[0] // 3, heads)]
        state[name] = torch.from_numpy(arr.copy())
    return state


def load_state_strict(model: torch.nn.Module, state: dict) -> None:
    """Load ``state`` into ``model``: every entry used, every parameter set."""
    own = model.state_dict()
    unused = sorted(set(state) - set(own))
    missing = sorted(set(own) - set(state))
    if unused or missing:
        raise KeyError(f"weights do not fit the model: unused {unused[:8]} "
                       f"({len(unused)}), missing {missing[:8]} ({len(missing)})")
    for name, value in state.items():
        if tuple(own[name].shape) != tuple(value.shape):
            raise ValueError(f"{name}: blob shape {tuple(value.shape)}, "
                             f"model shape {tuple(own[name].shape)}")
    model.load_state_dict(state, strict=True)


def load_blob_into(model: torch.nn.Module, path: str | Path,
                   num_heads: dict[str, int] | None = None) -> tuple[dict, dict]:
    """Load a committed blob strictly into ``model``; returns (model_conf, meta)."""
    flat, model_conf, meta = load_weight_blob(path)
    load_state_strict(model, params_from_flat(flat, num_heads))
    return model_conf, meta
