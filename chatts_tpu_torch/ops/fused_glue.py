"""The decoder layer's elementwise glue fused into the CUDA kernels of
``csrc/fused_glue.cu``, the gate that decides where they engage, and the
count of the glue's call sites by the path they took.

Replaces no TPU kernel: XLA fuses this glue on the TPU; PyTorch launches it
op by op.  The wrappers are for CUDA tensors only.  Their plain versions are
the eager compositions in ``models/qwen.py`` (``rms_norm`` after a residual
add, ``F.silu(gate) * up``, ``Attention._qkv`` with ``_cache_values`` and
``_write_cache``), which run wherever the gate says no, and which the card's
tests hold the kernels to:

- ``add_rms_norm(x, branch, weight, eps)``: ``x + branch`` (the new residual
  stream) and its RMSNorm, or the norm of ``x`` alone when ``branch`` is
  None.
- ``silu_mul(gate, up)``: ``F.silu(gate) * up``.
- ``qkv_decode(...)``: a decode step's qkv epilogue; q (B, H, D) returned,
  K/V written into the cache at ``write_pos``.

``engaged`` is the gate: CUDA bf16 tensors that autograd records none of,
and no tensor-parallel mesh; then the shapes a kernel takes (``norm_fits``,
``silu_fits``, ``qkv_fits``).  Training, LoRA, tensor parallelism and the
CPU keep the eager functions.  The count of the glue's call sites by the
path they took: each wrapper's ``.launches`` (the fused calls), and
``eager``, the call sites in ``models/qwen.py`` that ran their eager
composition, by the kernel they would take (a prefill's or a mixed step's
qkv epilogue, which has no kernel, counts under ``qkv_decode``).  A graph's
replay runs no Python and counts nothing; its capture counts once
(``counting``).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Callable, Dict, Optional, Sequence

import torch

from chatts_tpu_torch.kernels import build

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "chatts_add_rms_norm": (_I, [_P] * 5 + [_I, _I, _F, _P]),
    "chatts_silu_mul": (_I, [_P] * 3 + [_I, _I, _L, _L, _P]),
    "chatts_qkv_decode": (_I, [_P] * 3 + [_L] * 3 + [_P] * 5 + [_F] + [_P] * 8
                          + [_I] * 5 + [_P]),
}

VEC = 8  # bf16 elements a 16-byte load
MAX_HIDDEN = VEC * 4 * 1024  # add_rms_norm: four vectors a thread, 1,024 threads

eager: Dict[str, int] = {"add_rms_norm": 0, "silu_mul": 0, "qkv_decode": 0}
_eager_lock = threading.Lock()


def engaged(mesh, *tensors: Optional[torch.Tensor]) -> bool:
    """Whether a glue call site over ``tensors`` (None entries ignored) may
    take its fused kernel: no tensor-parallel mesh, autograd records none of
    them, and each is a CUDA bf16 tensor."""
    ts = [t for t in tensors if t is not None]
    return (mesh is None
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in ts))
            and all(t.is_cuda and t.dtype == torch.bfloat16 for t in ts))


def take(site: str, fused: bool) -> bool:
    """Count call site ``site`` (a kernel's name) in ``eager`` unless it
    goes ``fused`` (the wrapper counts that launch); returns ``fused``."""
    if not fused:
        with _eager_lock:
            eager[site] += 1
    return fused


def counts() -> Dict[str, int]:
    """The glue's call sites so far, process-wide: {"fused": launches of
    the three wrappers, "eager": eager compositions}."""
    with _eager_lock:
        n_eager = sum(eager.values())
    return {"fused": add_rms_norm.launches + silu_mul.launches + qkv_decode.launches,
            "eager": n_eager}


def counting(step: Callable[[], object], into: Dict[str, int]) -> Callable[[], object]:
    """``step`` that also writes into ``into`` the glue's call sites it ran
    (``counts()`` after less before): a graph capture's record."""
    def counted():
        before = counts()
        out = step()
        into.update({k: v - before[k] for k, v in counts().items()})
        return out
    return counted


def _rows_fit(*tensors: torch.Tensor) -> bool:
    """Contiguous, 16-byte aligned rows of whole 16-byte vectors."""
    return all(t.is_contiguous() and t.data_ptr() % 16 == 0 and t.shape[-1] % VEC == 0
               for t in tensors)


def norm_fits(x: torch.Tensor, branch: Optional[torch.Tensor], weight: torch.Tensor) -> bool:
    """Whether ``add_rms_norm`` takes these tensors."""
    ts = [x, weight] + ([] if branch is None else [branch])
    return (x.shape[-1] <= MAX_HIDDEN and weight.shape == x.shape[-1:]
            and (branch is None or branch.shape == x.shape) and _rows_fit(*ts))


def add_rms_norm(x: torch.Tensor, branch: Optional[torch.Tensor], weight: torch.Tensor,
                 eps: float):
    """(x + branch, rms_norm(x + branch)) of bf16 rows (..., H), or (x,
    rms_norm(x)) when ``branch`` is None, in one launch."""
    if not x.is_cuda:
        raise ValueError(f"add_rms_norm: no kernel for device {x.device}")
    build.refuse_gradients("add_rms_norm", x, weight, *([] if branch is None else [branch]))
    if not norm_fits(x, branch, weight):
        raise ValueError(f"add_rms_norm: the kernel does not take x {tuple(x.shape)}, "
                         f"weight {tuple(weight.shape)}")
    lib = build.load("fused_glue", _SIGNATURES)
    h = x.shape[-1]
    normed = torch.empty_like(x)
    resid = x if branch is None else torch.empty_like(x)
    err = lib.chatts_add_rms_norm(
        x.data_ptr(), None if branch is None else branch.data_ptr(), weight.data_ptr(),
        None if branch is None else resid.data_ptr(), normed.data_ptr(), x.numel() // h, h,
        eps, build.stream_handle(x.device))
    add_rms_norm.launches += 1
    build.check_launch(err, "add_rms_norm")
    return resid, normed


add_rms_norm.launches = 0


def silu_fits(gate: torch.Tensor, up: torch.Tensor) -> bool:
    """Whether ``silu_mul`` takes these: (R, I) each, unit column stride,
    16-byte aligned rows."""
    return (gate.dim() == 2 and gate.shape == up.shape and gate.shape[1] % VEC == 0
            and all(t.stride(1) == 1 and t.stride(0) % VEC == 0 and t.data_ptr() % 16 == 0
                    for t in (gate, up)))


def silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """F.silu(gate) * up of (R, I) bf16 rows, each at its own row stride
    (the two halves of a fused gate_up output), contiguous (R, I)."""
    if not gate.is_cuda:
        raise ValueError(f"silu_mul: no kernel for device {gate.device}")
    build.refuse_gradients("silu_mul", gate, up)
    if not silu_fits(gate, up):
        raise ValueError(f"silu_mul: the kernel does not take gate {tuple(gate.shape)} "
                         f"strides {gate.stride()}, up strides {up.stride()}")
    lib = build.load("fused_glue", _SIGNATURES)
    r, i = gate.shape
    out = torch.empty((r, i), dtype=gate.dtype, device=gate.device)
    err = lib.chatts_silu_mul(gate.data_ptr(), up.data_ptr(), out.data_ptr(), r, i,
                              gate.stride(0), up.stride(0), build.stream_handle(gate.device))
    silu_mul.launches += 1
    build.check_launch(err, "silu_mul")
    return out


silu_mul.launches = 0


def qkv_fits(kv_cache: Sequence[torch.Tensor], head_dim: int) -> bool:
    """Whether ``qkv_decode`` writes this cache: the int8 4-tuple (codes,
    codes, f32 scales, f32 scales) or a bf16 pair, contiguous, and a head
    size that is a multiple of 64 up to 256."""
    if head_dim % 64 or head_dim > 256 or not all(c.is_contiguous() for c in kv_cache):
        return False
    if len(kv_cache) == 4:
        return (kv_cache[0].dtype == kv_cache[1].dtype == torch.int8
                and kv_cache[2].dtype == kv_cache[3].dtype == torch.float32)
    return len(kv_cache) == 2 and all(c.dtype == torch.bfloat16 for c in kv_cache)


def qkv_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               biases: Sequence[Optional[torch.Tensor]],
               q_norm: Optional[torch.Tensor], k_norm: Optional[torch.Tensor], eps: float,
               cos: torch.Tensor, sin: torch.Tensor, write_pos: torch.Tensor,
               kv_cache: Sequence[torch.Tensor], num_heads: int, num_kv_heads: int,
               head_dim: int) -> torch.Tensor:
    """A decode step's qkv epilogue, one token a row b < B.

    q, k, v: (B, heads * D) bf16, the projections' outputs before their
    bias (rows at any stride, columns unit-stride); ``biases`` the three
    biases (bf16, or None each), added in f32 and rounded to bf16 as
    ``Dense`` adds them; then the q/k norms where given, RoPE from cos, sin
    (B, D) f32.  Writes K and V into ``kv_cache`` (``qkv_fits``) at each
    row's ``write_pos`` (B,) int32: int8 codes and scales as ``quantize_kv``
    makes them, or the bf16 values.  Returns q (B, H, D) contiguous."""
    if not q.is_cuda:
        raise ValueError(f"qkv_decode: no kernel for device {q.device}")
    build.refuse_gradients("qkv_decode", q, k, v)
    b, h, kvh, d = q.shape[0], num_heads, num_kv_heads, head_dim
    if not qkv_fits(kv_cache, d):
        raise ValueError("qkv_decode: the cache is neither int8 nor bf16 of a head size "
                         f"it takes (D {d})")
    widths = (h * d, kvh * d, kvh * d)
    for t, w, bias in zip((q, k, v), widths, biases):
        if t.dtype != torch.bfloat16 or t.shape != (b, w) or t.stride(1) != 1:
            raise ValueError(f"qkv_decode: q, k, v must be bf16 ({b}, heads * {d}) rows "
                             f"with unit column stride; got {tuple(t.shape)} {t.stride()}")
        if bias is not None and (bias.dtype != torch.bfloat16 or bias.shape != (w,)
                                 or not bias.is_contiguous()):
            raise ValueError(f"qkv_decode: a bias must be contiguous bf16 ({w},)")
    for t in (q_norm, k_norm):
        if t is not None and (t.dtype != torch.bfloat16 or t.shape != (d,)
                              or not t.is_contiguous()):
            raise ValueError(f"qkv_decode: a q/k norm must be contiguous bf16 ({d},)")
    for t in (cos, sin):
        if t.dtype != torch.float32 or t.shape != (b, d) or not t.is_contiguous():
            raise ValueError(f"qkv_decode: cos and sin must be contiguous f32 ({b}, {d})")
    if write_pos.dtype != torch.int32 or write_pos.shape != (b,) or not write_pos.is_contiguous():
        raise ValueError(f"qkv_decode: write_pos must be contiguous int32 ({b},)")
    bc, ckvh, s, cd = kv_cache[0].shape
    if bc < b or ckvh != kvh or cd != d:
        raise ValueError(f"qkv_decode: cache {tuple(kv_cache[0].shape)} does not hold "
                         f"{b} rows of {kvh} heads of {d}")

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = build.load("fused_glue", _SIGNATURES)
    q_out = torch.empty((b, h, d), dtype=torch.bfloat16, device=q.device)
    scales = (kv_cache[2], kv_cache[3]) if len(kv_cache) == 4 else (None, None)
    err = lib.chatts_qkv_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), k.stride(0), v.stride(0),
        *(ptr(t) for t in biases), ptr(q_norm), ptr(k_norm), eps, cos.data_ptr(),
        sin.data_ptr(), write_pos.data_ptr(), q_out.data_ptr(), kv_cache[0].data_ptr(),
        kv_cache[1].data_ptr(), *(ptr(t) for t in scales), b, h, kvh, d, s,
        build.stream_handle(q.device))
    qkv_decode.launches += 1
    build.check_launch(err, "qkv_decode")
    return q_out


qkv_decode.launches = 0
