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

The other way, ``encode_msgpack`` writes the same subset (flax's ndarray and
numpy-scalar ext types included), so ``flax.serialization.msgpack_restore``
reads what it writes, and ``flat_from_params`` turns a ``state_dict`` back
into the flat flax keys and layouts.
"""

from __future__ import annotations

import re
import struct
from pathlib import Path

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3  # a numpy scalar, packed as a 0-d array


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
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, raw = decode_msgpack(data)
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr

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


def _pack_header(out: bytearray, n: int, fix: int | None, fix_max: int, codes: tuple) -> None:
    """A container's or string's type byte and length: the fix form when it
    fits, else the 8/16/32-bit length form (``codes``; None where there is none)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    forms = ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF), (0xCE, ">I", 0, 0xFFFFFFFF),
             (0xCF, ">Q", 0, 2**64 - 1)) if v >= 0 else (
        (0xD0, ">b", -2**7, 2**7 - 1), (0xD1, ">h", -2**15, 2**15 - 1),
        (0xD2, ">i", -2**31, 2**31 - 1), (0xD3, ">q", -2**63, 2**63 - 1))
    for code, fmt, lo, hi in forms:
        if lo <= v <= hi:
            out.append(code)
            out += struct.pack(fmt, v)
            return
    raise ValueError(f"integer {v} does not fit msgpack")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_header(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        arr = np.asarray(obj, order="C")  # (ascontiguousarray makes 0-d arrays 1-d)
        _pack_ext(out, _EXT_NDARRAY, encode_msgpack((list(arr.shape), arr.dtype.name,
                                                     arr.tobytes())))
    elif isinstance(obj, np.generic):
        arr = np.asarray(obj)
        _pack_ext(out, _EXT_NPSCALAR, encode_msgpack(([], arr.dtype.name, arr.tobytes())))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_header(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray)):
        _pack_header(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_header(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _pack_header(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for key, value in sorted(obj.items()):  # flax's tree_map sorts them
            if not isinstance(key, str):
                raise TypeError(f"msgpack map keys must be str here, got {key!r}")
            _pack(out, key)
            _pack(out, value)
    else:
        raise TypeError(f"cannot encode {type(obj).__name__} as msgpack")


def encode_msgpack(obj) -> bytes:
    """Encode ``obj`` (dicts with str keys, lists, tuples, str, bytes, int,
    float, bool, None, numpy arrays and scalars) as flax's
    ``msgpack_serialize`` does: arrays as ext type 1 holding (shape, dtype
    name, raw bytes), numpy scalars as ext type 3, floats as float64, map
    keys sorted: the same bytes as flax's."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


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


# a LayerNorm: LightGlue's 'ffn_norm', SuperGlue's MLP 'norm_0', 'norm_1', ...,
# LoFTR's 'norm1', 'norm2'
_NORM = re.compile(r"norm(_?\d+)?$")


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
    elif leaf == "scale" and modules and _NORM.search(modules[-1]):
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


# --- PyTorch state_dict -> flax parameter tree (the inverse) -------------------

_INVERSE_RENAMES = [  # on the module path, dot-terminated
    (re.compile(r"\b(transformers|log_assignment|token_confidence)\.(\d+)\."), r"\1_\2."),
    (re.compile(r"\bcross_attn\.ffn\.(\d)\."), r"cross_attn.ffn.ffn.\1."),
    (re.compile(r"\bffn\.0\."), "ffn_0."),
    (re.compile(r"\bffn\.1\."), "ffn_norm."),
    (re.compile(r"\bffn\.3\."), "ffn_2."),
    (re.compile(r"\btoken\.0\."), "token."),
    (re.compile(r"\bposenc\.Wr\."), "posenc."),
]


def flax_key(name: str) -> str:
    """The flat flax key of the PyTorch parameter ``name``, the inverse of
    ``_torch_name``: e.g. ``matcher.transformers.0.cross_attn.ffn.1.weight``
    -> ``"['params']['matcher']['transformers_0']['cross_attn']['ffn']
    ['ffn_norm']['scale']"``."""
    modules, leaf = name.rsplit(".", 1)
    path = modules + "."
    for pattern, repl in _INVERSE_RENAMES:
        path = pattern.sub(repl, path)
    parts = path.rstrip(".").split(".")
    if leaf == "weight":
        leaf = "scale" if _NORM.search(parts[-1]) else "kernel"
    return "".join(f"['{p}']" for p in ["params", *parts, leaf])


def flat_from_params(state: dict, num_heads: dict[str, int] | None = None) -> dict:
    """PyTorch state_dict -> flat flax params (float32 numpy arrays): the
    inverse of ``params_from_flat``, Wqkv rows put back in flax's order."""
    flat = {}
    for name, value in state.items():
        key = flax_key(name)
        path = _flax_path(key)
        arr = value.detach().cpu().numpy()
        if "Wqkv" in path:
            prefix = name.split("transformers.")[0].rstrip(".")
            heads = (num_heads or {}).get(prefix)
            if heads is None:
                raise KeyError(f"{name}: no head count given for {prefix!r}")
            arr = arr[np.argsort(_qkv_rows(arr.shape[0] // 3, heads))]
        if path[-1] == "kernel":
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
        flat[key] = np.asarray(arr, order="C")  # 0-d stays 0-d (SuperGlue's bin_score)
    return flat


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
