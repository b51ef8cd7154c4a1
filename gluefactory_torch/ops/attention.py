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
  - the kernel's layout, chosen here by the amount of work and the card's
    SM count (``plan_attention``) and passed to the kernel as arguments;
  - a ``torch.autograd.Function`` around each kernel (``AttentionFn``,
    ``SelfAttentionRotaryFn``), the counterparts of the JAX package's
    ``_attention_fused`` and ``_self_attention_rotary_fused``: the forward
    launches the kernel and saves the inputs, the backward recomputes the
    softmax in plain PyTorch (``attention_bwd``, ``self_attention_rotary_bwd``,
    copies of ``_attention_bwd`` and ``_sar_bwd``) -- the JAX package's
    backward is a jnp recompute too, not a Pallas kernel;
  - a dispatcher (``attention``, ``self_attention_rotary``) that the models
    call: ``implementation='xla'`` selects the plain version, ``'auto'`` and
    ``'pallas'`` the kernel through its Function (the JAX package's names, so
    its configs keep their meaning).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import kernels

NEG_INF = -1e30
SOURCE = "attention.cu"
HEAD_DIMS = (64,)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

KEY_TILE = 64  # keys per K/V tile of the kernel
DEFAULT_SMS = 132  # an H100 SXM's SMs: the plan's default where no card is asked

# launches of each CUDA kernel in this process
launches = {"attention": 0, "attention_rotary": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _attention_probs(q: torch.Tensor, k: torch.Tensor,
                     kv_mask: torch.Tensor | None) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) over the keys, in float32, with the kernels'
    mask rules: masked keys take no part in the max or the sum, the
    denominator is clamped at 1e-30 (a fully-masked row is 0)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    if kv_mask is not None:
        drop = ~kv_mask[:, None, None, :]
        s = s.masked_fill(drop, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if kv_mask is not None:
        e = e.masked_fill(drop, 0.0)
    return e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v. q (B, H, Nq, D), k/v (B, H, Nk, D),
    kv_mask (B, Nk) bool (True = keep). Fully-masked rows return zeros."""
    p = _attention_probs(q, k, kv_mask)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def rotate_pairs(x: torch.Tensor) -> torch.Tensor:
    """interleave(-x2, x1) over the last dim: the P of x * cos + P(x) * sin
    (``_P`` in the JAX package)."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding over the last dim, pairs convention
    x * cos + interleave(-x2, x1) * sin. x (B, H, N, D); cos/sin (B, N, D)."""
    return x * cos[:, None] + rotate_pairs(x) * sin[:, None]


def attention_rotary_plain(q: torch.Tensor, k_rotated: torch.Tensor, v: torch.Tensor,
                           cos: torch.Tensor, sin: torch.Tensor,
                           kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of kernel K1: q rotated in float32, then attention."""
    qr = apply_rotary(q.float(), cos.float(), sin.float())
    return attention_plain(qr, k_rotated, v, kv_mask).to(q.dtype)


class AttentionPlan(NamedTuple):
    """The kernel's layout. The grid is (ceil(Nq / rows), B*H, splits):
    block (x, bh, s) takes query rows [x*rows, (x+1)*rows) and key tiles
    [s*tiles_per_split, (s+1)*tiles_per_split) of KEY_TILE keys each. With
    ``splits`` > 1 the splits write partial softmax states that a second
    kernel merges."""

    rows: int  # query rows per block: 16 per warp, 16, 32 or 64
    tiles_per_split: int
    splits: int


def plan_attention(b: int, h: int, nq: int, nk: int, sms: int = DEFAULT_SMS) -> AttentionPlan:
    """Blocks of 64 query rows; when they are too few to fill the card's
    ``sms`` SMs twice, the key tiles are split into ranges so that the grid
    reaches 2 * ``sms`` blocks, at most one split per tile."""
    full_grid = 2 * sms
    n_tiles = math.ceil(nk / KEY_TILE)
    rows = 64
    blocks = b * h * math.ceil(nq / rows)
    if blocks >= full_grid:
        return AttentionPlan(rows, n_tiles, 1)
    tiles_per_split = math.ceil(n_tiles / min(n_tiles, math.ceil(full_grid / max(blocks, 1))))
    return AttentionPlan(rows, tiles_per_split, math.ceil(n_tiles / tiles_per_split))


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _library() -> ctypes.CDLL:
    lib = kernels.load(SOURCE)
    if lib.gf_attention.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gf_attention.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        lib.gf_attention.restype = i
        lib.gf_attention_rotary.argtypes = [i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
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
    if name != "kv_mask" and t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel copies 16-byte chunks and needs a "
                         "16-byte-aligned tensor")


def _check_inputs(q, k, v, kv_mask):
    if q.device.type != "cuda":
        raise ValueError(f"the attention kernels run on CUDA tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q and k must be (B, H, N, D)")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"no attention kernel for dtype {q.dtype}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("the raw kernel wrappers have no backward pass: "
                                  "call attention()/self_attention_rotary(), whose "
                                  "autograd Functions launch the kernels")
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


def _scratch(plan: AttentionPlan, q: torch.Tensor) -> tuple[torch.Tensor | None, int, int]:
    """The split plan's f32 scratch in one tensor: partial accumulators
    (splits, B*H, Nq, D), then (max, sum) pairs (splits, B*H, Nq, 2); none
    for one split. Returns it with the addresses of both parts. Freed after
    the launch is enqueued, it goes back to the allocator in stream order."""
    if plan.splits == 1:
        return None, 0, 0
    b, h, nq, d = q.shape
    n = plan.splits * b * h * nq
    part = torch.empty(n * (d + 2), dtype=torch.float32, device=q.device)
    return part, part.data_ptr(), part.data_ptr() + n * d * 4


def _plan_for(q: torch.Tensor, nk: int) -> AttentionPlan:
    b, h, nq, _ = q.shape
    return plan_attention(b, h, nq, nk, _sm_count(q.device.index))


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel K2: masked attention. Same contract as ``attention_plain``."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_mask)
    _check_inputs(q, k, v, kv_mask)
    if q.shape[2] == 0:
        return torch.empty_like(q)
    return _launch_attention(q, k, v, kv_mask, _plan_for(q, k.shape[2]))


def _launch_attention(q, k, v, kv_mask, plan: AttentionPlan) -> torch.Tensor:
    """K2 under ``plan`` on inputs that ``_check_inputs`` accepted."""
    b, h, nq, d = q.shape
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        _part, part_o, part_ml = _scratch(plan, q)
        rc = lib.gf_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_mask is None else kv_mask.data_ptr(), out.data_ptr(), part_o, part_ml,
            b, h, nq, k.shape[2], d, *plan, torch.cuda.current_stream(q.device).cuda_stream)
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
    return _launch_attention_rotary(q, k_rotated, v, cos, sin, kv_mask, _plan_for(q, nk))


def _launch_attention_rotary(q, k_rotated, v, cos, sin, kv_mask,
                             plan: AttentionPlan) -> torch.Tensor:
    """K1 under ``plan`` on inputs that ``attention_rotary_cuda`` accepted."""
    b, h, n, d = q.shape
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        _part, part_o, part_ml = _scratch(plan, q)
        rc = lib.gf_attention_rotary(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_rotated.data_ptr(), v.data_ptr(),
            cos.data_ptr(), sin.data_ptr(),
            None if kv_mask is None else kv_mask.data_ptr(), out.data_ptr(), part_o, part_ml,
            b, h, n, d, *plan, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "attention_rotary")
    launches["attention_rotary"] += 1
    return out


# --- autograd --------------------------------------------------------------

def attention_bwd(q, k, v, kv_mask, g):
    """(dq, dk, dv) of ``attention_plain`` for the output cotangent ``g``,
    recomputed from the inputs in float32 (JAX ``_attention_bwd``)."""
    q, k, v, g = q.float(), k.float(), v.float(), g.float()
    scale = q.shape[-1] ** -0.5
    p = _attention_probs(q, k, kv_mask)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g)
    dp = torch.einsum("bhqd,bhkd->bhqk", g, v)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale
    return dq, dk, dv


def rotary_bwd_rotate(g, cos, sin):
    """Adjoint of ``apply_rotary`` in x: J = diag(cos) + diag(sin) P with
    P^T = -P, so J^T g = apply_rotary(g, cos, -sin) (JAX ``_rotary_bwd_rotate``)."""
    return apply_rotary(g, cos, -sin)


def self_attention_rotary_bwd(q, k, v, cos, sin, kv_mask, g):
    """(dq, dk, dv, dcos, dsin) of rotary self-attention with q and k
    unrotated (JAX ``_sar_bwd``). dcos/dsin (B, N, D) are summed over heads:
    they feed the learnable Fourier posenc that makes cos and sin."""
    q, k, cos, sin = q.float(), k.float(), cos.float(), sin.float()
    qr, kr = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
    dqr, dkr, dv = attention_bwd(qr, kr, v, kv_mask, g)
    dq = rotary_bwd_rotate(dqr, cos, sin)
    dk = rotary_bwd_rotate(dkr, cos, sin)
    dcos = (dqr * q + dkr * k).sum(dim=1)
    dsin = (dqr * rotate_pairs(q) + dkr * rotate_pairs(k)).sum(dim=1)
    return dq, dk, dv, dcos, dsin


class AttentionFn(torch.autograd.Function):
    """Kernel K2 forward, plain recompute backward (JAX ``_attention_fused``)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask):
        ctx.save_for_backward(q, k, v, kv_mask)
        return attention_cuda(q, k, v, kv_mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, kv_mask, g)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


class SelfAttentionRotaryFn(torch.autograd.Function):
    """Kernel K1 forward (k rotated here, q in the kernel), plain recompute
    backward with gradients for cos and sin (JAX ``_self_attention_rotary_fused``)."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, kv_mask):
        ctx.save_for_backward(q, k, v, cos, sin, kv_mask)
        k_rot = apply_rotary(k, cos, sin).contiguous()
        return attention_rotary_cuda(q, k_rot, v, cos, sin, kv_mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v, cos, sin, kv_mask = ctx.saved_tensors
        grads = self_attention_rotary_bwd(q, k, v, cos, sin, kv_mask, g)
        return (*(d.to(t.dtype) for d, t in zip(grads, (q, k, v, cos, sin))), None)


def _use_kernel(implementation: str) -> bool:
    if implementation not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown attention implementation {implementation!r}")
    return implementation != "xla"


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_mask: torch.Tensor | None = None,
              implementation: str = "auto") -> torch.Tensor:
    """Multi-head attention (B, H, N, D) with an optional key padding mask."""
    if _use_kernel(implementation):
        return AttentionFn.apply(q.contiguous(), k.contiguous(), v.contiguous(), kv_mask)
    return attention_plain(q, k, v, kv_mask)


def self_attention_rotary(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cos: torch.Tensor, sin: torch.Tensor,
                          kv_mask: torch.Tensor | None = None,
                          implementation: str = "auto") -> torch.Tensor:
    """Rotary self-attention: k is rotated once outside the kernel, q inside."""
    if _use_kernel(implementation):
        return SelfAttentionRotaryFn.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                           cos.contiguous(), sin.contiguous(), kv_mask)
    return attention_plain(apply_rotary(q, cos, sin), apply_rotary(k, cos, sin), v, kv_mask)
