"""Masked multi-head attention for the matcher transformers, with and without
a rotary embedding of q (gluefactory_tpu/ops/attention.py).

Each kernel has three parts here:
  - a plain PyTorch version (``attention_plain``, ``attention_rotary_plain``),
    copied from the JAX package's
    ``attention_xla`` and ``apply_rotary``. It computes in float32 and
    returns q's dtype, as the TPU kernels do;
  - a wrapper (``attention_cuda``, ``attention_rotary_cuda``) that checks its
    inputs and launches the hand-written CUDA kernel of
    ``csrc/attention.cu`` on CUDA tensors, counting each launch in
    ``launches``. Given CPU tensors it runs the plain version instead;
  - a dispatcher (``attention``, ``self_attention_rotary``) that the models
    call: ``implementation='xla'`` selects the plain version, ``'auto'`` and
    ``'pallas'`` the kernel wrapper (the JAX package's names, so its configs
    keep their meaning).
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels

NEG_INF = -1e30
SOURCE = "attention.cu"
HEAD_DIMS = (64,)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

# launches of each CUDA kernel in this process
launches = {"attention": 0, "attention_rotary": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v. q (B, H, Nq, D), k/v (B, H, Nk, D),
    kv_mask (B, Nk) bool (True = keep). Fully-masked rows return zeros."""
    dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
    if kv_mask is not None:
        drop = ~kv_mask[:, None, None, :]
        s = s.masked_fill(drop, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if kv_mask is not None:
        e = e.masked_fill(drop, 0.0)
    p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding over the last dim, pairs convention
    x * cos + interleave(-x2, x1) * sin. x (B, H, N, D); cos/sin (B, N, D)."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    rot = torch.stack([-x2, x1], dim=-1).reshape(x.shape)
    return x * cos[:, None] + rot * sin[:, None]


def attention_rotary_plain(q: torch.Tensor, k_rotated: torch.Tensor, v: torch.Tensor,
                           cos: torch.Tensor, sin: torch.Tensor,
                           kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of kernel K1: q rotated in float32, then attention."""
    qr = apply_rotary(q.float(), cos.float(), sin.float())
    return attention_plain(qr, k_rotated, v, kv_mask).to(q.dtype)


def _library() -> ctypes.CDLL:
    lib = kernels.load(SOURCE)
    if lib.gf_attention.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gf_attention.argtypes = [i, p, p, p, p, p, i, i, i, i, i, p]
        lib.gf_attention.restype = i
        lib.gf_attention_rotary.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, p]
        lib.gf_attention_rotary.restype = i
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors only")


def _check_inputs(q, k, v, kv_mask):
    if q.device.type != "cuda":
        raise ValueError(f"the attention kernels run on CUDA tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q and k must be (B, H, N, D)")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"no attention kernel for dtype {q.dtype}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("the attention kernels have no backward pass yet")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"no attention kernel for head dim {d}; have {HEAD_DIMS}")
    if nk < 1:
        raise ValueError("attention needs at least one key")
    _check("q", q, (b, h, nq, d), q.dtype, q.device)
    _check("k", k, (b, h, nk, d), q.dtype, q.device)
    _check("v", v, (b, h, nk, d), q.dtype, q.device)
    if kv_mask is not None:
        _check("kv_mask", kv_mask, (b, nk), torch.bool, q.device)
    return b, h, nq, nk, d


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: error {rc}")


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel K2: masked attention. Same contract as ``attention_plain``."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_mask)
    b, h, nq, nk, d = _check_inputs(q, k, v, kv_mask)
    out = torch.empty_like(q)
    if nq == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.gf_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_mask is None else kv_mask.data_ptr(), out.data_ptr(),
            b, h, nq, nk, d, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "attention")
    launches["attention"] += 1
    return out


def attention_rotary_cuda(q: torch.Tensor, k_rotated: torch.Tensor, v: torch.Tensor,
                          cos: torch.Tensor, sin: torch.Tensor,
                          kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel K1: self-attention with q rotated in the kernel. ``k_rotated``
    arrives rotated; cos/sin (B, N, D) are shared across heads."""
    if q.device.type == "cpu":
        return attention_rotary_plain(q, k_rotated, v, cos, sin, kv_mask)
    b, h, nq, nk, d = _check_inputs(q, k_rotated, v, kv_mask)
    if nq != nk:
        raise ValueError(f"rotary self-attention needs Nq == Nk, got {nq} and {nk}")
    _check("cos", cos, (b, nq, d), q.dtype, q.device)
    _check("sin", sin, (b, nq, d), q.dtype, q.device)
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.gf_attention_rotary(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_rotated.data_ptr(), v.data_ptr(),
            cos.data_ptr(), sin.data_ptr(),
            None if kv_mask is None else kv_mask.data_ptr(), out.data_ptr(),
            b, h, nq, d, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "attention_rotary")
    launches["attention_rotary"] += 1
    return out


def _use_kernel(implementation: str) -> bool:
    if implementation not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown attention implementation {implementation!r}")
    return implementation != "xla"


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_mask: torch.Tensor | None = None,
              implementation: str = "auto") -> torch.Tensor:
    """Multi-head attention (B, H, N, D) with an optional key padding mask."""
    if _use_kernel(implementation):
        return attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), kv_mask)
    return attention_plain(q, k, v, kv_mask)


def self_attention_rotary(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cos: torch.Tensor, sin: torch.Tensor,
                          kv_mask: torch.Tensor | None = None,
                          implementation: str = "auto") -> torch.Tensor:
    """Rotary self-attention: k is rotated here once, q inside the kernel."""
    k_rot = apply_rotary(k, cos, sin)
    if _use_kernel(implementation):
        return attention_rotary_cuda(q.contiguous(), k_rot.contiguous(), v.contiguous(),
                                     cos.contiguous(), sin.contiguous(), kv_mask)
    return attention_plain(apply_rotary(q, cos, sin), k_rot, v, kv_mask)
