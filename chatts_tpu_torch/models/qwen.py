"""Qwen2 / Qwen3 dense decoder as PyTorch modules.

Counterpart of ``chatts_tpu/models/qwen.py``: RMSNorm -> GQA attention (RoPE,
qkv bias for Qwen2, per-head q/k RMSNorm for Qwen3) -> RMSNorm -> SwiGLU MLP,
a residual around each; final RMSNorm; tied, separate or int4 lm_head.

Weights keep the JAX package's (in, out) orientation and its packed int4
layout, so the two packages load the same arrays without transposes
(``models/convert.py``).  KV caches are head-major (B, KVH, S, D) and are
written in place: prefill writes the prompt block, each decode step writes one
position per (row, head) with one indexed assignment.

On CUDA tensors the hot spots are the port's kernels: prefill attention
(``ops/flash_attention.py``), decode attention
(``ops/ragged_decode_attention.py``) and every int4 projection
(``ops/int4_matmul.py``: ``int4_matmul``, or ``int4_matmul_a8`` for a
prefill with ``act_int8``).  On CPU tensors each runs its plain version.
The elementwise glue between them takes the kernels of
``ops/fused_glue.py`` where their gate lets it (CUDA bf16 tensors that
autograd does not record, no mesh): each residual add with the norm after it
(``add_rms_norm``; a layer hands its MLP output to the next layer's input
norm, ``DecoderLayer.forward_residual``), SiLU x up (``silu_mul``) and a
decode step's qkv epilogue with its cache write; everywhere else the eager
functions here run.

A layer cache is a (k, v) pair of float tensors, or the int8 4-tuple
(k_q, v_q, k_scale, v_scale) of ``runtime/kv_cache.py``.  With an int8 cache
prefill writes codes and scales but attends over the unquantized fresh
block, as the reference does; decode writes the new token's codes and scales
and attends through ``ragged_decode_attention_int8``.

A chunk of T > 1 tokens at ``write_pos`` (B, T) (chunked prefill) writes its
K/V at those slots, then attends the cache prefix ``[:kv_limit]`` through the
prefill attention: the prefix is viewed token-major and made contiguous, an
int8 one dequantized first (code * scale in f32, then q's type), so a chunk
reads its own keys in their quantized form, as the reference does.

``QwenModel.forward_mixed`` is the serving engine's mixed step (the port of
``qwen.forward_mixed``): B decode tokens and A admission rows of ``npt``
prompt tokens in one packed stream through every projection; decode tokens
attend as a decode step, prompt tokens over their slots' cache prefix.

``act_int8`` (prefill only, as in the reference) quantizes each projection's
input rows to int8: int4 weights then take ``int4_matmul_a8`` and int8
weights an int8 x int8 -> int32 product; float weights ignore it.

``load_torch_state_dict`` builds the decoder from an HF state dict
(``models/weights.py`` loads checkpoint directories); ``init_params`` a
random float one.

Training (``chatts_tpu_torch/train/``) runs the uncached forward under
autograd with ``attn_impl="xla"`` (the plain attention: the kernels have no
backward and refuse gradients), optionally ``remat`` (each layer under
``torch.utils.checkpoint``), and a float ``Dense`` folds in a LoRA adapter
attached to it (``Dense.lora``).

Under tensor parallelism (``parallel/sharding.py::place_params``) each rank
holds its Megatron shard and the model carries the mesh: q, k, v, gate and
up are column-parallel and o and down row-parallel (``Dense.tp_kind``), a
row projection's bias added once, after the sum over tp; attention runs on
the rank's heads, through ``ragged_decode_attention_tp`` and
``..._int8_tp`` in decode; the embedding is vocab-parallel (a masked lookup,
then a sum) and the head column-parallel, its logits gathered over the
vocab.  A part that tp does not divide is replicated whole and runs with no
collective.  Where autograd records (training on a mesh), the sums and the
gather go through ``parallel/mesh.py``'s autograd pairs (``reduce_from_tp``,
``gather_from_tp``), and a column-parallel block's input through
``copy_to_tp``, whose backward sums the input's gradient over tp; under
``torch.no_grad`` the in-place collectives run, as in inference.  A LoRA
adapter on a shard is whole (``train/lora.py``): a column layer folds in
its columns of ``b``, a row layer its rows of ``a``.

Recent-KV decode is TPU-only machinery and is not ported.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from chatts_tpu_torch.core.config import QwenConfig
from chatts_tpu_torch.ops import fused_glue as glue
from chatts_tpu_torch.ops.attention import attention
from chatts_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_a8, int4_matmul_tp
from chatts_tpu_torch.ops.ragged_decode_attention import (
    ragged_decode_attention,
    ragged_decode_attention_int8,
    ragged_decode_attention_int8_tp,
    ragged_decode_attention_tp,
)
from chatts_tpu_torch.parallel.mesh import (
    all_gather_tp,
    all_reduce_tp,
    copy_to_tp,
    gather_from_tp,
    max_tp,
    reduce_from_tp,
)

LayerCache = Tuple[torch.Tensor, ...]


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, cast back to x's type."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * weight.float()).to(x.dtype)


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables at the given positions; (B, T, head_dim) each, f32."""
    half = head_dim // 2
    exponents = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv_freq = 1.0 / (theta ** exponents)
    angles = positions.float()[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def add_rms_norm(x: torch.Tensor, branch: Optional[torch.Tensor], weight: torch.Tensor,
                 eps: float, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual stream ``x + branch`` (``x`` itself where ``branch`` is
    None) and its ``rms_norm``: one kernel where the glue gate lets it
    (``ops/fused_glue.py``), else the add and ``rms_norm``."""
    fused = glue.engaged(mesh, x, branch, weight)
    if fused:  # the kernel reads whole rows: a chunk's view of the embeddings is copied
        x, branch = x.contiguous(), None if branch is None else branch.contiguous()
    if glue.take("add_rms_norm", fused and glue.norm_fits(x, branch, weight)):
        return glue.add_rms_norm(x, branch, weight, eps)
    if branch is not None:
        x = x + branch
    return x, rms_norm(x, weight, eps)


def silu_mul(gate: torch.Tensor, up: torch.Tensor, mesh=None) -> torch.Tensor:
    """``F.silu(gate) * up``: one kernel where the glue gate lets it, else
    the two ops."""
    g2, u2 = gate.reshape(-1, gate.shape[-1]), up.reshape(-1, up.shape[-1])
    if glue.take("silu_mul", glue.engaged(mesh, gate, up) and glue.silu_fits(g2, u2)):
        return glue.silu_mul(g2, u2).reshape(gate.shape)
    return F.silu(gate) * up


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE (HF/NeoX convention) in f32.  x: (B, T, H, D)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    out = x.float() * cos[:, :, None, :] + rotated.float() * sin[:, :, None, :]
    return out.to(x.dtype)


def quantize_acts(x: torch.Tensor, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the last axis, one scale per row: the port of
    ``qwen._quantize_acts`` (and of ``_quantize_kv``, the same arithmetic).
    x (..., K) -> (int8 codes, f32 scales (...)).  ``torch.round`` rounds
    half to even, as ``jnp.round`` does, so the same f32 input gives the
    same codes and scales, on the CPU and on the card.  With ``mesh`` x is
    this rank's part of rows split over tp, and a row's maximum is taken
    over the whole row, as GSPMD takes it."""
    xf = x.float()
    amax = max_tp(mesh, xf.abs().amax(dim=-1))
    # A tensor divisor: on CUDA, PyTorch divides by a Python scalar as a
    # multiply by its reciprocal, which can round the other way.
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


# K/V (B, KVH, T, D) -> codes and scales (B, KVH, T), per position.
quantize_kv = quantize_acts


class _MatmulF32(torch.autograd.Function):
    """(R, K) @ (K, N) of one 16-bit type to the f32 product, with the
    backward of JAX's transpose rule for ``dot(x, w,
    preferred_element_type=f32)``: the f32 cotangent times the other
    operand, each gradient rounded to its operand's type (``dx`` in x's,
    ``dw`` in w's).  The cotangent enters the products in the operands' type,
    as the TPU's default precision rounds an f32 operand to bf16; the
    products themselves are f32-output cuBLAS GEMMs."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(w.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(g, w.t(), out_dtype=torch.float32).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(x2.t(), g, out_dtype=torch.float32).to(w.dtype)
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) as the f32 product, not rounded to the operands'
    type: ``jnp.dot(x, w, preferred_element_type=float32)``.  On the card a
    bf16 or f16 pair takes cuBLAS's f32-output GEMM (``torch.mm`` with
    ``out_dtype``, which that PyTorch registers only for CUDA), through
    ``_MatmulF32`` when autograd records it; anything else multiplies the
    operands cast to f32."""
    if x.device.type == "cuda" and x.dtype == w.dtype and x.dtype in (
            torch.bfloat16, torch.float16):
        x2 = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            out = _MatmulF32.apply(x2, w)
        else:
            out = torch.mm(x2, w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def lora_kernel(kernel: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                scale: float) -> torch.Tensor:
    """A float kernel (in, out) with a LoRA adapter folded in, as
    ``chatts_tpu/train/lora.py::apply_lora`` folds it: ``(W.float() +
    (a.float() @ b.float()) * scale).to(W.dtype)``, a (in, r), b (r, out)."""
    delta = (a.float() @ b.float()) * scale
    return (kernel.float() + delta).to(kernel.dtype)


def _int8_matmul(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(R, K) int8 @ (K, N) int8 -> (R, N) int32, exact.  ``torch._int_mm``
    takes more than 16 rows on the card, so fewer are padded with zero rows
    and cut off after."""
    r = xq.shape[0]
    if r <= 16:
        xq = F.pad(xq, (0, 0, 0, 17 - r))
    return torch._int_mm(xq, w)[:r]


def embed_tokens(table: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(input_ids.long(), table)


def _recorded(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _sum_tp(mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum over tp of partial results: ``reduce_from_tp`` where autograd
    records ``x``, else in place."""
    return reduce_from_tp(mesh, x) if _recorded(x) else all_reduce_tp(mesh, x)


def _gather_tp(mesh, x: torch.Tensor) -> torch.Tensor:
    """``x``'s last dim gathered over tp: ``gather_from_tp`` where autograd
    records ``x``."""
    return gather_from_tp(mesh, x) if _recorded(x) else all_gather_tp(mesh, x)


def _block_input(dense: "Dense", x: torch.Tensor) -> torch.Tensor:
    """The input of the column-parallel block ``dense`` opens: where
    autograd records it, ``copy_to_tp``, so that its gradient, partial on
    each rank, is summed over tp."""
    if dense.tp_kind == "col" and _recorded(x):
        return copy_to_tp(dense.mesh, x)
    return x


def _frozen(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t, requires_grad=False)


class Dense(nn.Module):
    """One projection: the port of ``qwen._dense``.

    - Float: ``kernel`` (in, out).
    - int4: ``kernel_q4`` (in/2, out) int8 and ``scales4`` (in/128, out)
      f32, optionally GPTQ ``zeros4`` (groups, out) and ``perm4`` (in,)
      applied in plain PyTorch around the kernel.
    - int8: ``kernel_q`` (in, out) int8 and per-column ``scales`` (out,)
      f32, W = kernel_q * scales.

    Results are rounded as the reference rounds them: float and int8
    products are f32 (``matmul_f32``); the int4 kernels return x's type, which
    is then cast to f32; the bias is added in f32 and the sum cast to x's
    type.  Where nothing is added to a whole int4 product (no bias, no
    zero-points, no mesh) the kernel's output is returned as it is: the round
    trip through f32 is exact.  ``act_int8`` quantizes the rows of x first
    (``quantize_acts``).

    ``lora``, None or (a, b, scale) set by ``train/lora.py::applied_lora``
    on a float ``Dense``, folds the adapter into the kernel on every call
    (``lora_kernel``); the adapter is whole, (in, r) and (r, out) of the
    whole layer, and a shard folds in its part (``shard_adapter``).

    ``mesh`` is the mesh of a model placed on one, and ``tp_kind`` the
    layer's tensor-parallel kind there (``parallel/sharding.py``): "" is
    replicated (the whole layer, no collective); "col" holds this rank's
    output columns and takes the whole input; "row" holds its input rows
    (and their groups; ``perm4`` this rank's part of the permutation,
    ``scales`` and the bias whole) and takes this rank's part of the input,
    and the partial products are summed over tp before the bias: int4 ones
    in x's type through ``int4_matmul_tp``, as JAX's psum sums them, and
    those of asymmetric, activation-order, float and int8 layers in f32
    (int8 activations in int32), as GSPMD reduces their dots.  Under a mesh
    int4 layers, replicated ones too, ignore ``act_int8``, as JAX's do
    (``chatts_tpu/models/qwen.py`` takes its a8 kernel only without a
    mesh); an activation-order row layer gathers its input over tp first,
    since its permutation is global."""

    def __init__(self, kernel: Optional[torch.Tensor] = None, *,
                 kernel_q4: Optional[torch.Tensor] = None,
                 scales4: Optional[torch.Tensor] = None,
                 zeros4: Optional[torch.Tensor] = None,
                 perm4: Optional[torch.Tensor] = None,
                 kernel_q: Optional[torch.Tensor] = None,
                 scales: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None,
                 mesh=None, tp_kind: str = ""):
        super().__init__()
        if tp_kind not in ("", "col", "row") or (tp_kind and mesh is None):
            raise ValueError(f"tp_kind is '', 'col' or 'row', and a shard takes a mesh; "
                             f"got tp_kind {tp_kind!r}")
        if sum(w is not None for w in (kernel, kernel_q4, kernel_q)) != 1:
            raise ValueError("Dense takes one of a float kernel, kernel_q4 + scales4 "
                             "or kernel_q + scales")
        if kernel_q4 is not None and scales4 is None:
            raise ValueError("kernel_q4 needs scales4")
        if kernel_q is not None and scales is None:
            raise ValueError("kernel_q needs scales")
        if kernel_q is not None:
            # Column-major strides, the same (in, out) values: cuBLASLt's int8
            # GEMM behind torch._int_mm takes its second operand only so.
            kernel_q = kernel_q.t().contiguous().t()
        self.kernel = _frozen(kernel)
        self.bias = _frozen(bias)
        self.mesh, self.tp_kind = mesh, tp_kind
        self.lora: Optional[Tuple[torch.Tensor, torch.Tensor, float]] = None
        for name, t in (("kernel_q4", kernel_q4), ("scales4", scales4),
                        ("zeros4", zeros4), ("perm4", perm4),
                        ("kernel_q", kernel_q), ("scales", scales)):
            self.register_buffer(name, t)

    @property
    def in_features(self) -> int:
        if self.kernel_q4 is not None:
            return 2 * self.kernel_q4.shape[0]
        return self._weight.shape[0]

    @property
    def out_features(self) -> int:
        return self._weight.shape[1]

    @property
    def whole_shape(self) -> Tuple[int, int]:
        """(in, out) of the whole layer this one is a shard of (or is)."""
        tp = self.mesh.tp if self.tp_kind else 1
        if self.tp_kind == "row":
            return self.in_features * tp, self.out_features
        return self.in_features, self.out_features * tp

    def shard_adapter(self, a: torch.Tensor, b: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The part of a whole adapter (a (in, r), b (r, out)) this shard
        folds in: a column layer's columns of ``b`` and a row layer's rows of
        ``a``, the shard's own range (``sharding.column_index`` of one
        part); a whole layer's all of it."""
        if self.tp_kind == "col":
            n = self.out_features
            b = b.narrow(1, self.mesh.tp_index * n, n)
        elif self.tp_kind == "row":
            n = self.in_features
            a = a.narrow(0, self.mesh.tp_index * n, n)
        return a, b

    @property
    def _weight(self) -> torch.Tensor:
        return next(w for w in (self.kernel, self.kernel_q4, self.kernel_q) if w is not None)

    @property
    def _whole_int4(self) -> bool:
        """int4 with the kernel's output the whole product: no zero-points,
        and no mesh to sum it over."""
        return self.kernel_q4 is not None and self.zeros4 is None and self.mesh is None

    def forward_unbiased(self, x: torch.Tensor, act_int8: bool = False
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(y, bias): for a whole int4 projection the kernel's output in x's
        type and the bias still to be added (in f32, the sum rounded to x's
        type, as ``forward`` adds it); else (``forward(x)``, None)."""
        if not self._whole_int4:
            return self(x, act_int8), None
        y, _ = self._int4_rows(self._int4_input(x), act_int8)
        return y.reshape(*x.shape[:-1], y.shape[-1]), self.bias

    def _int4_input(self, x: torch.Tensor) -> torch.Tensor:
        """x's rows (R, in) as the int4 kernels take them: in ``perm4``'s
        order where there is one (a row shard's input gathered over tp
        first: the permutation is global)."""
        x2 = x.reshape(-1, x.shape[-1])
        if self.perm4 is None:
            return x2
        mesh = self.mesh if self.tp_kind == "row" else None
        return all_gather_tp(mesh, x2, dim=1).index_select(1, self.perm4.long())

    def _int4_rows(self, x2: torch.Tensor, act_int8: bool) -> Tuple[torch.Tensor, bool]:
        """The int4 kernel's product of rows ``x2`` (``_int4_input``), in
        their type, and whether it was summed over tp already."""
        if self.tp_kind and self.zeros4 is None and self.perm4 is None:
            return int4_matmul_tp(x2.contiguous(), self.kernel_q4, self.scales4,
                                  mesh=self.mesh, kind=self.tp_kind), True
        if act_int8 and self.mesh is None:
            xq, xs = quantize_acts(x2)
            return int4_matmul_a8(xq, xs, self.kernel_q4, self.scales4, out_dtype=x2.dtype), False
        return int4_matmul(x2.contiguous(), self.kernel_q4, self.scales4), False

    def forward(self, x: torch.Tensor, act_int8: bool = False) -> torch.Tensor:
        if self._whole_int4:
            y, bias = self.forward_unbiased(x, act_int8)
            return y if bias is None else (y.float() + bias.float()).to(x.dtype)
        lead = x.shape[:-1]
        mesh = self.mesh if self.tp_kind == "row" else None  # the group a row layer sums over
        reduced = False
        if self.kernel_q4 is not None:
            x2 = self._int4_input(x)
            y, reduced = self._int4_rows(x2, act_int8)
            out = y.float()
            if self.zeros4 is not None:
                # Asymmetric GPTQ zero-points: W = s*(code-8) + s*(8-z); the
                # second term needs only each group's activation sum, taken
                # from the unquantized rows.
                g = self.zeros4.shape[0]
                rs = x2.float().reshape(x2.shape[0], g, -1).sum(dim=-1)
                out = out + torch.matmul(rs, self.zeros4.float())
            out = out.reshape(*lead, out.shape[-1])
        elif self.kernel_q is not None:
            if act_int8:
                xq, xs = quantize_acts(x.reshape(-1, x.shape[-1]), mesh)
                acc = all_reduce_tp(mesh, _int8_matmul(xq, self.kernel_q))
                out = acc.float() * xs[:, None] * self.scales
                out = out.reshape(*lead, out.shape[-1])
            else:
                out = all_reduce_tp(mesh, matmul_f32(x, self.kernel_q.to(x.dtype))) * self.scales
            reduced = True
        elif self.lora is not None:
            a, b, scale = self.lora
            out = matmul_f32(x, lora_kernel(self.kernel, *self.shard_adapter(a, b), scale))
        else:
            out = matmul_f32(x, self.kernel)
        if not reduced:
            out = _sum_tp(mesh, out)
        if self.bias is not None:
            out = out + self.bias.float()
        return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Decoder layer
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """GQA self-attention.  Projections are either ``qkv_proj`` (fused, output
    laid out [q | k | v]) or ``q_proj``/``k_proj``/``v_proj``.
    ``num_heads`` and ``num_kv_heads`` are the heads this module computes
    (the config's unless a tensor-parallel shard holds fewer); ``mesh``
    marks heads sharded over its tp, whose decode takes the ``_tp``
    wrappers."""

    def __init__(self, cfg: QwenConfig, o_proj: Dense, *,
                 qkv_proj: Optional[Dense] = None,
                 q_proj: Optional[Dense] = None, k_proj: Optional[Dense] = None,
                 v_proj: Optional[Dense] = None,
                 q_norm: Optional[torch.Tensor] = None,
                 k_norm: Optional[torch.Tensor] = None,
                 num_heads: Optional[int] = None, num_kv_heads: Optional[int] = None,
                 mesh=None):
        super().__init__()
        if (qkv_proj is None) == (q_proj is None):
            raise ValueError("Attention takes either qkv_proj or q/k/v_proj")
        if cfg.qk_norm and (q_norm is None or k_norm is None):
            raise ValueError("a Qwen3 config needs q_norm and k_norm")
        self.cfg = cfg
        self.qkv_proj, self.q_proj, self.k_proj, self.v_proj = qkv_proj, q_proj, k_proj, v_proj
        self.o_proj = o_proj
        self.q_norm = _frozen(q_norm)
        self.k_norm = _frozen(k_norm)
        self.num_heads = cfg.num_attention_heads if num_heads is None else num_heads
        self.num_kv_heads = cfg.num_key_value_heads if num_kv_heads is None else num_kv_heads
        self.mesh = mesh

    def _qkv(self, x, rope, act_int8: bool = False):
        """q (B, T, H, D), k and v (B, T, KVH, D) of x (B, T, hidden): the
        projections, the Qwen3 q/k norms and RoPE."""
        cfg = self.cfg
        b, t, _ = x.shape
        h, kvh, d = self.num_heads, self.num_kv_heads, cfg.head_dim
        x = _block_input(self.qkv_proj or self.q_proj, x)
        if self.qkv_proj is not None:
            q, k, v = self.qkv_proj(x, act_int8).split([h * d, kvh * d, kvh * d], dim=-1)
        else:
            q = self.q_proj(x, act_int8)
            k = self.k_proj(x, act_int8)
            v = self.v_proj(x, act_int8)
        q = q.reshape(b, t, h, d)
        k = k.reshape(b, t, kvh, d)
        v = v.reshape(b, t, kvh, d).contiguous()
        if self.q_norm is not None:
            q = rms_norm(q, self.q_norm, cfg.rms_norm_eps)
            k = rms_norm(k, self.k_norm, cfg.rms_norm_eps)
        cos, sin = rope
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def forward(
        self,
        x: torch.Tensor,  # (B, T, hidden)
        positions: torch.Tensor,  # (B, T) int32
        rope: Tuple[torch.Tensor, torch.Tensor],
        kv_cache: Optional[LayerCache],
        write_pos: Optional[torch.Tensor],  # (B, T) int32: cache slots of the block
        kv_valid: Optional[torch.Tensor],  # (B, S) bool
        kv_positions: Optional[torch.Tensor],  # (B, S) int32
        kv_lengths: Optional[torch.Tensor],  # (B,) int32 for a decode step
        act_int8: bool = False,
        kv_limit: Optional[int] = None,
        attn_impl: str = "auto",
    ) -> Tuple[torch.Tensor, Optional[LayerCache]]:
        """``attn_impl`` picks the prefill attention of the T block
        (``ops/attention.py::attention``): "auto" or "xla"."""
        cfg = self.cfg
        b, t, _ = x.shape
        h, d = self.num_heads, cfg.head_dim
        scale = d ** -0.5
        decode = kv_cache is not None and write_pos is not None and kv_lengths is not None
        projs = [self.qkv_proj] if self.qkv_proj is not None else [
            self.q_proj, self.k_proj, self.v_proj]
        fused = decode and glue.engaged(self.o_proj.mesh, x, self.q_norm, self.k_norm,
                                        *(p.bias for p in projs)) and glue.qkv_fits(kv_cache, d)
        if glue.take("qkv_decode", fused):
            q1 = self._qkv_decode_fused(x, rope, kv_cache, write_pos, act_int8)
            out = _decode_attention(q1, kv_cache, kv_lengths, scale, self.mesh)[:, None]
            return self.o_proj(out.reshape(b, t, h * d), act_int8), kv_cache
        q, k, v = self._qkv(x, rope, act_int8)
        if kv_cache is not None:
            # This block's K/V head-major (B, KVH, T, D), as the cache stores it.
            values = _cache_values(kv_cache, k.transpose(1, 2), v.transpose(1, 2))

        if kv_cache is not None and write_pos is not None:
            # Decode step or prefill chunk: write the block at write_pos
            # first, then attend over the cache.
            rows = torch.arange(b, device=x.device)[:, None, None]
            heads = torch.arange(self.num_kv_heads, device=x.device)[None, :, None]
            _write_cache(kv_cache, (rows, heads, write_pos.long()[:, None, :]), values)
            if kv_lengths is not None:
                # Decode: the first kv_lengths positions (the new one counted).
                out = _decode_attention(q[:, 0].contiguous(), kv_cache, kv_lengths, scale,
                                        self.mesh)[:, None]
            else:
                # Chunk: the cache prefix [:kv_limit], masked by kv_valid and
                # by position (slots not written yet lie after the chunk).
                limit = kv_cache[0].shape[2] if kv_limit is None else min(
                    kv_limit, kv_cache[0].shape[2])
                k_att, v_att = _cache_prefix(kv_cache, None, limit, q.dtype)
                out = attention(
                    q, k_att, v_att, q_positions=positions.contiguous(),
                    kv_positions=kv_positions[:, :limit].contiguous(),
                    kv_valid=kv_valid[:, :limit].contiguous(), scale=scale,
                )
        else:
            if kv_cache is not None:
                # Prefill: write the block at offset 0 but attend over the
                # fresh, unquantized T block only, not the cache's capacity.
                _write_cache(kv_cache, (slice(None), slice(None), slice(0, t)), values)
                kv_valid = kv_valid[:, :t].contiguous()
                kv_positions = kv_positions[:, :t].contiguous()
            out = attention(
                q, k, v, q_positions=positions, kv_positions=kv_positions,
                kv_valid=kv_valid, scale=scale, impl=attn_impl,
            )
        return self.o_proj(out.reshape(b, t, h * d), act_int8), kv_cache

    def _qkv_decode_fused(self, x, rope, kv_cache: LayerCache, write_pos: torch.Tensor,
                          act_int8: bool = False) -> torch.Tensor:
        """A decode step's ``_qkv`` and cache write in one kernel
        (``glue.qkv_decode``) after the projections: q (B, H, D)."""
        b = x.shape[0]
        h, kvh, d = self.num_heads, self.num_kv_heads, self.cfg.head_dim
        x2 = x.reshape(b, -1)
        if self.qkv_proj is not None:
            y, bias = self.qkv_proj.forward_unbiased(x2, act_int8)
            widths = [h * d, kvh * d, kvh * d]
            q, k, v = y.split(widths, dim=-1)
            biases = [None] * 3 if bias is None else bias.split(widths)
        else:
            (q, bq), (k, bk), (v, bv) = (p.forward_unbiased(x2, act_int8)
                                         for p in (self.q_proj, self.k_proj, self.v_proj))
            biases = [bq, bk, bv]
        cos, sin = (c.reshape(b, d) for c in rope)
        return glue.qkv_decode(q, k, v, biases, self.q_norm, self.k_norm, self.cfg.rms_norm_eps,
                               cos, sin, write_pos.reshape(b).to(torch.int32), kv_cache, h, kvh,
                               d)

    def forward_mixed(self, x: torch.Tensor, rope, kv_cache: LayerCache,
                      step: "MixedStep") -> torch.Tensor:
        """The mixed step's attention block (the port of
        ``qwen._mixed_attention``): x (1, B + A*npt, hidden) packed, decode
        tokens first.  Returns (1, B + A*npt, hidden)."""
        cfg = self.cfg
        h, d = self.num_heads, cfg.head_dim
        b, a, npt = step.b, step.a, step.npt
        glue.take("qkv_decode", False)  # the qkv epilogue stays eager here
        q, k, v = (z[0] for z in self._qkv(x, rope))  # (Tp, H|KVH, D)
        scale = d ** -0.5
        values = _cache_values(kv_cache, k, v)  # (Tp, KVH, D) and scales (Tp, KVH)
        heads = torch.arange(self.num_kv_heads, device=x.device)
        # One position a decode row.  An inactive row (the admission's slots
        # among them) writes back what its position holds: its stale
        # position may lie inside a prompt span written before.
        _write_cache(kv_cache, (step.rows[:, None], heads[None, :], step.dec_pos[:, None]),
                     [None if z is None else z[:b] for z in values], where=step.dec_write)
        # One (KVH, npt) span a row at the shared start.  A pad row writes
        # row 0's span into row 0's slot, the same values again.
        _write_cache(kv_cache, (step.adm_write_slots[:, None, None], heads[None, :, None],
                                step.span_pos[None, None, :]),
                     [None if z is None else
                      z[b:].reshape(a, npt, *z.shape[1:])[step.adm_src].transpose(1, 2)
                      for z in values])
        out_dec = _decode_attention(q[:b].contiguous(), kv_cache, step.dec_kv_lengths, scale,
                                    self.mesh)
        # Prompt tokens: their slots' cache prefix, masked by each row's
        # length and by position.
        k_adm, v_adm = _cache_prefix(kv_cache, step.adm_slots, step.kv_limit, q.dtype)
        out_pro = attention(
            q[b:].reshape(a, npt, h, d), k_adm, v_adm,
            q_positions=step.adm_q_positions, kv_positions=step.adm_kv_positions,
            kv_valid=step.adm_kv_valid, scale=scale,
        )
        out = torch.cat([out_dec.reshape(b, h * d), out_pro.reshape(a * npt, h * d)])
        return self.o_proj(out[None])


def _cache_values(kv_cache: LayerCache, k: torch.Tensor, v: torch.Tensor):
    """K/V (..., D) as the cache stores them: (codes, codes, scales, scales)
    for an int8 cache, (k, v, None, None) in a float cache's type."""
    if len(kv_cache) == 4:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        return kq, vq, ks, vs
    if len(kv_cache) == 2:
        return k.to(kv_cache[0].dtype), v.to(kv_cache[1].dtype), None, None
    raise ValueError(f"a layer cache is a 2-tuple or an int8 4-tuple, not {len(kv_cache)} tensors")


def _write_cache(kv_cache: LayerCache, index, values,
                 where: Optional[torch.Tensor] = None) -> None:
    """``buf[index] = value`` for each buffer of the cache, in place; the
    index selects (row, head, position), so it fits codes and scales alike.
    With ``where`` (a bool per value's leading index), a False one writes
    back the value its index holds: the shapes stay fixed and nothing
    changes there."""
    for buf, value in zip(kv_cache, values):
        if where is not None:
            keep = where.view(-1, *[1] * (value.dim() - 1))
            value = torch.where(keep, value, buf[index])
        buf[index] = value


def _decode_attention(q1: torch.Tensor, kv_cache: LayerCache, kv_lengths: torch.Tensor,
                      scale: float, mesh=None) -> torch.Tensor:
    """One query a row (B, H, D) over each row's first kv_lengths positions
    of the head-major cache: B4 for an int8 cache, else B2; through their
    ``_tp`` wrappers on heads sharded over ``mesh``."""
    if len(kv_cache) == 4:
        if mesh is not None:
            return ragged_decode_attention_int8_tp(q1, *kv_cache, kv_lengths, mesh=mesh,
                                                   scale=scale)
        return ragged_decode_attention_int8(q1, *kv_cache, kv_lengths, scale=scale)
    k_cache, v_cache = (c.to(q1.dtype) for c in kv_cache)
    if mesh is not None:
        return ragged_decode_attention_tp(q1, k_cache, v_cache, kv_lengths, mesh=mesh,
                                          scale=scale)
    return ragged_decode_attention(q1, k_cache, v_cache, kv_lengths, scale=scale)


def _cache_prefix(kv_cache: LayerCache, rows: Optional[torch.Tensor], limit: int, dtype):
    """K and V of the cache's first ``limit`` positions (of ``rows`` only,
    where given) token-major (R, limit, KVH, D), contiguous, in ``dtype``;
    an int8 cache dequantized first, code * scale in f32."""
    def one(buf, buf_scale):
        x = buf[:, :, :limit]
        if rows is not None:
            x = x.index_select(0, rows)
        if buf_scale is not None:
            s = buf_scale[:, :, :limit]
            if rows is not None:
                s = s.index_select(0, rows)
            x = x.float() * s[..., None]
        return x.to(dtype).transpose(1, 2).contiguous()

    if len(kv_cache) == 4:
        return one(kv_cache[0], kv_cache[2]), one(kv_cache[1], kv_cache[3])
    return one(kv_cache[0], None), one(kv_cache[1], None)


class MLP(nn.Module):
    """SwiGLU: ``gate_up_proj`` (fused, [gate | up]) or ``gate_proj`` + ``up_proj``."""

    def __init__(self, down_proj: Dense, *, gate_up_proj: Optional[Dense] = None,
                 gate_proj: Optional[Dense] = None, up_proj: Optional[Dense] = None):
        super().__init__()
        if (gate_up_proj is None) == (gate_proj is None):
            raise ValueError("MLP takes either gate_up_proj or gate_proj + up_proj")
        self.gate_up_proj, self.gate_proj, self.up_proj = gate_up_proj, gate_proj, up_proj
        self.down_proj = down_proj

    def forward(self, x: torch.Tensor, act_int8: bool = False) -> torch.Tensor:
        x = _block_input(self.gate_up_proj or self.gate_proj, x)
        if self.gate_up_proj is not None:
            gate, up = self.gate_up_proj(x, act_int8).chunk(2, dim=-1)
        else:
            gate, up = self.gate_proj(x, act_int8), self.up_proj(x, act_int8)
        return self.down_proj(silu_mul(gate, up, self.down_proj.mesh), act_int8)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: QwenConfig, self_attn: Attention, mlp: MLP,
                 input_layernorm: torch.Tensor, post_attention_layernorm: torch.Tensor):
        super().__init__()
        self.cfg = cfg
        self.self_attn = self_attn
        self.mlp = mlp
        self.input_layernorm = _frozen(input_layernorm)
        self.post_attention_layernorm = _frozen(post_attention_layernorm)

    def forward(self, x, positions, rope, kv_cache, write_pos, kv_valid,
                kv_positions, kv_lengths, act_int8: bool = False,
                kv_limit: Optional[int] = None, attn_impl: str = "auto"):
        x, branch = self.forward_residual(x, None, positions, rope, kv_cache, write_pos,
                                          kv_valid, kv_positions, kv_lengths, act_int8,
                                          kv_limit, attn_impl)
        return x + branch, kv_cache

    def forward_residual(self, x, branch, positions, rope, kv_cache, write_pos, kv_valid,
                         kv_positions, kv_lengths, act_int8: bool = False,
                         kv_limit: Optional[int] = None, attn_impl: str = "auto"):
        """The layer with each residual add left to the norm after it
        (``add_rms_norm``): ``x`` is the stream before ``branch``, the
        previous layer's MLP output (None for the first layer), is added.
        Returns the stream before this layer's MLP output is added, and that
        output."""
        return self._residual(x, branch, act_int8, lambda normed: self.self_attn(
            normed, positions, rope, kv_cache, write_pos, kv_valid, kv_positions, kv_lengths,
            act_int8, kv_limit, attn_impl)[0])

    def forward_mixed(self, x, branch, rope, kv_cache, step: "MixedStep"):
        """``forward_residual`` for the mixed step."""
        return self._residual(x, branch, False, lambda normed: self.self_attn.forward_mixed(
            normed, rope, kv_cache, step))

    def _residual(self, x, branch, act_int8: bool, attend):
        eps, mesh = self.cfg.rms_norm_eps, self.self_attn.o_proj.mesh
        x, normed = add_rms_norm(x, branch, self.input_layernorm, eps, mesh)
        x, normed = add_rms_norm(x, attend(normed), self.post_attention_layernorm, eps, mesh)
        return x, self.mlp(normed, act_int8)


def _recompute_contexts():
    """``checkpoint``'s (forward, recompute) contexts: the recompute marked
    for ``torch.profiler``."""
    return contextlib.nullcontext(), torch.profiler.record_function("recompute")


@dataclasses.dataclass
class MixedStep:
    """What the layers of one mixed step share (``QwenModel.forward_mixed``
    builds it): B decode rows, then A admission rows of npt prompt tokens.
    Every tensor's shape is fixed by (B, A, npt, kv_limit), so a CUDA graph
    can hold the step."""

    b: int
    a: int
    npt: int
    rows: torch.Tensor  # (B,) int64: 0 .. B - 1
    dec_write: torch.Tensor  # (B,) bool: the decode rows whose K/V is written
    dec_pos: torch.Tensor  # (B,) int64: their write positions
    dec_kv_lengths: torch.Tensor  # (B,) int32
    adm_slots: torch.Tensor  # (A,) int64: each admission row's cache row (pads read any)
    adm_src: torch.Tensor  # (A,) int64: the row whose span each row writes (pads: row 0)
    adm_write_slots: torch.Tensor  # (A,) int64: adm_slots[adm_src]
    span_pos: torch.Tensor  # (npt,) int64: the prompt tokens' positions, shared by the rows
    kv_limit: int
    adm_q_positions: torch.Tensor  # (A, npt) int32
    adm_kv_positions: torch.Tensor  # (A, kv_limit) int32
    adm_kv_valid: torch.Tensor  # (A, kv_limit) bool


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

class QwenModel(nn.Module):
    """The decoder stack with its embedding table, final norm and head.

    ``mesh`` is the mesh a tensor-parallel model is placed on; with
    ``vocab_start`` set, ``embed_tokens`` holds vocabulary rows
    [vocab_start, vocab_start + its rows) of this rank and the head the same
    columns."""

    def __init__(self, cfg: QwenConfig, embed_tokens: torch.Tensor,
                 layers: Sequence[DecoderLayer], norm: torch.Tensor, *,
                 lm_head: Optional[torch.Tensor] = None,
                 lm_head_q: Optional[Dense] = None,
                 mesh=None, vocab_start: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = _frozen(embed_tokens)
        self.layers = nn.ModuleList(layers)
        self.norm = _frozen(norm)
        self.lm_head = _frozen(lm_head)  # (hidden, vocab)
        self.lm_head_q = lm_head_q
        self.mesh = mesh
        self.vocab_start = vocab_start

    @property
    def kv_heads(self) -> int:
        """The kv heads a layer's cache holds on this rank."""
        return self.layers[0].self_attn.num_kv_heads

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Token embeddings (..., hidden) of ``input_ids``.  Vocab-parallel:
        each rank looks up the ids in its rows, zeros for the rest, and the
        tp group sums the parts (exact: one part is nonzero)."""
        if self.vocab_start is None:
            return embed_tokens(self.embed_tokens, input_ids)
        rows = self.embed_tokens.shape[0]
        local = input_ids.long() - self.vocab_start
        inside = (local >= 0) & (local < rows)
        out = F.embedding(local.clamp(0, rows - 1), self.embed_tokens)
        out = torch.where(inside[..., None], out, torch.zeros((), dtype=out.dtype,
                                                               device=out.device))
        return _sum_tp(self.mesh, out)

    def forward(
        self,
        inputs_embeds: torch.Tensor,  # (B, T, hidden)
        positions: torch.Tensor,  # (B, T)
        *,
        kv_caches: Optional[List[LayerCache]] = None,
        write_pos: Optional[torch.Tensor] = None,
        kv_valid: Optional[torch.Tensor] = None,
        kv_positions: Optional[torch.Tensor] = None,
        kv_lengths: Optional[torch.Tensor] = None,
        act_int8: bool = False,
        kv_limit: Optional[int] = None,
        attn_impl: str = "auto",
        remat: bool = False,
    ) -> Tuple[torch.Tensor, Optional[List[LayerCache]]]:
        """Run the decoder stack; returns (hidden (B, T, hidden), caches).

        Without caches, attention is over the T block itself and kv_valid /
        kv_positions default to all-valid / the query positions.  With caches
        and no write_pos this is prefill: the block is written at offset 0.
        With write_pos (B, T) the block is written at those slots: with
        kv_lengths (B,), the cache length after the write, it is one decode
        step (T = 1); without, a prefill chunk attending the cache prefix
        ``[:kv_limit]`` (all of it when None) under kv_valid / kv_positions
        (B, S).  Caches are updated in place.  ``act_int8`` quantizes every
        projection's input rows (prefill).

        ``attn_impl`` ("auto" or "xla") picks the T block's attention (see
        ``Attention.forward``).  ``remat`` (no caches) runs each layer under
        ``torch.utils.checkpoint``: autograd keeps a layer's input only and
        recomputes the layer in the backward, marked "recompute" for
        ``torch.profiler``."""
        if remat and kv_caches is not None:
            raise ValueError("remat is for the uncached forward")
        b, t, _ = inputs_embeds.shape
        positions = positions.to(torch.int32)
        if kv_caches is not None and write_pos is not None and kv_lengths is not None:
            if t != 1:
                raise ValueError("kv_lengths is for a decode step of one token a row")
            kv_lengths = kv_lengths.to(torch.int32)
        else:
            if kv_caches is not None and write_pos is not None and (
                    kv_valid is None or kv_positions is None):
                raise ValueError("a prefill chunk needs kv_valid and kv_positions")
            if kv_valid is None:
                kv_valid = torch.ones((b, t), dtype=torch.bool, device=positions.device)
            if kv_positions is None:
                kv_positions = positions
            kv_valid = kv_valid.to(torch.bool)
            kv_positions = kv_positions.to(torch.int32)

        rope = rope_cos_sin(positions, self.cfg.head_dim, self.cfg.rope_theta)
        x, branch = inputs_embeds, None
        for i, layer in enumerate(self.layers):
            cache = kv_caches[i] if kv_caches is not None else None
            args = (positions, rope, cache, write_pos, kv_valid, kv_positions,
                    kv_lengths, act_int8, kv_limit, attn_impl)
            if remat:
                x, _ = checkpoint(layer, x, *args, use_reentrant=False,
                                  context_fn=_recompute_contexts, preserve_rng_state=False)
            else:
                x, branch = layer.forward_residual(x, branch, *args)
        return add_rms_norm(x, branch, self.norm, self.cfg.rms_norm_eps, self.mesh)[1], kv_caches

    def forward_mixed(
        self,
        embeds: torch.Tensor,  # (1, B + A*npt, hidden) packed: decode tokens first
        positions: torch.Tensor,  # (1, B + A*npt)
        *,
        b: int,
        a: int,
        npt: int,
        kv_caches: List[LayerCache],
        dec_rows: torch.Tensor,  # (B,) bool, or the (n,) int indices of its True rows
        dec_kv_lengths: torch.Tensor,  # (B,)
        adm_slots: torch.Tensor,  # (A,) int: each admission row's cache row
        n_real,  # int or 0-dim tensor: rows [0, n_real) are real; the rest are pads
        adm_seq_lens: torch.Tensor,  # (A,): prompt lengths, 0 for pads
        span_start,  # int or 0-dim tensor: the prompt tokens' first position
        kv_limit: int,
    ) -> torch.Tensor:
        """The fused mixed prefill + decode step: the port of
        ``qwen.forward_mixed``.  One packed stream of B decode tokens and A
        rows of npt prompt tokens runs through every projection together; a
        decode token writes its K/V at its position in its row (the rows of
        ``dec_rows`` only) and attends as a decode step over dec_kv_lengths;
        each real admission row writes its npt tokens at [span_start,
        span_start + npt) of its slot, and the prompt tokens attend their
        slots' prefix [:kv_limit], valid below adm_seq_lens.  Caches are
        updated in place.  The reference drops the writes of the other rows
        out of bounds; here they write values their places already hold, so
        that no shape or index depends on the host: ``n_real`` and
        ``span_start`` may be device scalars.  Returns the hidden states
        (1, B + A*npt, hidden) after the final norm."""
        dev = embeds.device
        positions = positions.to(torch.int32)
        rows = torch.arange(b, device=dev)
        if dec_rows.dtype == torch.bool:
            dec_write = dec_rows
        else:
            dec_write = torch.zeros((b,), dtype=torch.bool, device=dev)
            dec_write[dec_rows.long()] = True
        adm = torch.arange(a, device=dev)
        adm_src = torch.where(adm < n_real, adm, 0)
        adm_slots = adm_slots.long()
        kv_pos = torch.arange(kv_limit, dtype=torch.int32, device=dev)[None].repeat(a, 1)
        step = MixedStep(
            b=b, a=a, npt=npt, rows=rows, dec_write=dec_write,
            dec_pos=positions[0, :b].long(), dec_kv_lengths=dec_kv_lengths.to(torch.int32),
            adm_slots=adm_slots, adm_src=adm_src, adm_write_slots=adm_slots[adm_src],
            span_pos=torch.arange(npt, device=dev) + span_start, kv_limit=kv_limit,
            adm_q_positions=positions[0, b:].reshape(a, npt).contiguous(),
            adm_kv_positions=kv_pos, adm_kv_valid=kv_pos < adm_seq_lens[:, None],
        )
        rope = rope_cos_sin(positions, self.cfg.head_dim, self.cfg.rope_theta)
        x, branch = embeds, None
        for layer, cache in zip(self.layers, kv_caches):
            x, branch = layer.forward_mixed(x, branch, rope, cache, step)
        return add_rms_norm(x, branch, self.norm, self.cfg.rms_norm_eps, self.mesh)[1]

    def compute_logits(self, hidden: torch.Tensor, gather: bool = True) -> torch.Tensor:
        """hidden (B, T, hidden) -> logits (B, T, vocab), f32.  A quantized
        head returns hidden's type cast to f32, a float head the f32 product,
        as the reference does.  A vocab-parallel head's columns are gathered
        over tp, or, with ``gather=False``, this rank's columns
        [vocab_start, vocab_start + its rows) are returned (the
        vocab-parallel loss, ``train/loss.py``)."""
        mesh = self.mesh if self.vocab_start is not None else None
        if mesh is not None and _recorded(hidden):
            hidden = copy_to_tp(mesh, hidden)
        if self.lm_head_q is not None:
            local = self.lm_head_q(hidden)
        elif self.cfg.tie_word_embeddings or self.lm_head is None:
            local = matmul_f32(hidden, self.embed_tokens.t())
        else:
            local = matmul_f32(hidden, self.lm_head)
        if gather:
            local = _gather_tp(mesh, local)
        return local.float()


def fuse_projections(model: QwenModel) -> QwenModel:
    """Pack each layer's q/k/v kernels into ``qkv_proj`` and gate/up into
    ``gate_up_proj`` (one larger matmul each), in place.  Float weights only:
    quantized layers are fused before quantizing
    (``quantize.init_quantized_params(fused=True)``)."""
    for layer in model.layers:
        attn, mlp = layer.self_attn, layer.mlp
        if attn.qkv_proj is None:
            parts = (attn.q_proj, attn.k_proj, attn.v_proj)
            if any(p.kernel is None for p in parts):
                raise ValueError("fuse_projections takes float kernels")
            bias = None
            if parts[0].bias is not None:
                bias = torch.cat([p.bias for p in parts])
            attn.qkv_proj = Dense(torch.cat([p.kernel for p in parts], dim=1), bias=bias)
            attn.q_proj = attn.k_proj = attn.v_proj = None
        if mlp.gate_up_proj is None:
            if mlp.gate_proj.kernel is None or mlp.up_proj.kernel is None:
                raise ValueError("fuse_projections takes float kernels")
            mlp.gate_up_proj = Dense(
                torch.cat([mlp.gate_proj.kernel, mlp.up_proj.kernel], dim=1))
            mlp.gate_proj = mlp.up_proj = None
    return model


@torch.no_grad()
def init_params(cfg: QwenConfig, generator: torch.Generator, device="cuda",
                dtype=None, *, mesh=None, keep_layers: Optional[Sequence[int]] = None
                ) -> QwenModel:
    """A random float decoder, unfused: the port of
    ``chatts_tpu.models.qwen.init_params``, with its distributions and its
    order of draws (kernels normal / sqrt(fan_in), biases 0, norms 1,
    embeddings normal * 0.02, a separate head normal / sqrt(hidden)), drawn
    in f32 from ``generator`` on the generator's device, then cast to
    ``dtype`` (the config's by default) on ``device``.

    With ``mesh`` the result is this rank's shard, ``place_params``' cut of
    the same whole model, each layer cut as soon as it is drawn, so that no
    rank holds the whole model.  With ``keep_layers`` every layer is drawn
    but only those kept (a pipeline stage's, ``parallel/pipeline.py``)."""
    if dtype is None:
        dtype = getattr(torch, cfg.dtype)
    h, kvh, d, hid = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim, cfg.hidden_size

    def normal(shape, std: float) -> torch.Tensor:
        t = torch.randn(shape, generator=generator, device=generator.device) * std
        return t.to(device=device, dtype=dtype)

    def fill(n: int, value: float) -> torch.Tensor:
        return torch.full((n,), value, dtype=dtype, device=device)

    def dense(fan_in: int, fan_out: int, bias: bool) -> Dense:
        return Dense(normal((fan_in, fan_out), 1 / math.sqrt(fan_in)),
                     bias=fill(fan_out, 0.0) if bias else None)

    layers = []
    for i in range(cfg.num_hidden_layers):
        q = dense(hid, h * d, cfg.attention_bias)
        k = dense(hid, kvh * d, cfg.attention_bias)
        v = dense(hid, kvh * d, cfg.attention_bias)
        o = dense(h * d, hid, False)
        gate = dense(hid, cfg.intermediate_size, False)
        up = dense(hid, cfg.intermediate_size, False)
        down = dense(cfg.intermediate_size, hid, False)
        norms = {"q_norm": fill(d, 1.0), "k_norm": fill(d, 1.0)} if cfg.qk_norm else {}
        layer = DecoderLayer(
            cfg, Attention(cfg, o, q_proj=q, k_proj=k, v_proj=v, **norms),
            MLP(down, gate_proj=gate, up_proj=up), fill(hid, 1.0), fill(hid, 1.0))
        if keep_layers is not None and i not in keep_layers:
            continue
        if mesh is not None:
            from chatts_tpu_torch.parallel import sharding

            layer = sharding.shard_layer(layer, cfg, mesh, device)
        layers.append(layer)
        del q, k, v, o, gate, up, down, layer
    embed = normal((cfg.vocab_size, hid), 0.02)
    lm_head = None if cfg.tie_word_embeddings else normal((hid, cfg.vocab_size),
                                                          1 / math.sqrt(hid))
    model = QwenModel(cfg, embed, layers, fill(hid, 1.0), lm_head=lm_head)
    if mesh is None:
        return model
    from chatts_tpu_torch.parallel import sharding

    return sharding.place_vocab(mesh, cfg, model, layers, device)


# ---------------------------------------------------------------------------
# HF state dicts
# ---------------------------------------------------------------------------

def to_tensor(a, device=None) -> torch.Tensor:
    """A torch tensor or a numpy array (bfloat16 included, as ml_dtypes
    stores it) as a tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.int16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def state_tensor(state_dict, name: str, device=None) -> torch.Tensor:
    """``state_dict[name]`` as a tensor on ``device``; a state dict with
    ``get_tensor`` (``models/weights.py``) reads it straight to the device."""
    if hasattr(state_dict, "get_tensor"):
        return state_dict.get_tensor(name, device)
    return to_tensor(state_dict[name], device)


def build_layers(cfg: QwenConfig, norm: Callable[[str], torch.Tensor],
                 dense: Callable[[str, bool], Dense], prefix: str = "model.") -> List[DecoderLayer]:
    """The decoder layers under HF names: ``norm(name)`` gives a norm's
    weight, ``dense(name, bias)`` the unfused projection at ``name``
    (``...q_proj``) with its bias when ``bias``.  Read in the reference
    loader's order, a layer at a time."""
    layers = []
    for i in range(cfg.num_hidden_layers):
        lp = f"{prefix}layers.{i}."
        attn = lp + "self_attn."
        input_norm = norm(lp + "input_layernorm.weight")
        post_norm = norm(lp + "post_attention_layernorm.weight")
        q = dense(attn + "q_proj", cfg.attention_bias)
        k = dense(attn + "k_proj", cfg.attention_bias)
        v = dense(attn + "v_proj", cfg.attention_bias)
        o = dense(attn + "o_proj", False)
        gate = dense(lp + "mlp.gate_proj", False)
        up = dense(lp + "mlp.up_proj", False)
        down = dense(lp + "mlp.down_proj", False)
        norms = {}
        if cfg.qk_norm:
            norms = {"q_norm": norm(attn + "q_norm.weight"), "k_norm": norm(attn + "k_norm.weight")}
        layers.append(DecoderLayer(
            cfg, Attention(cfg, o, q_proj=q, k_proj=k, v_proj=v, **norms),
            MLP(down, gate_proj=gate, up_proj=up), input_norm, post_norm))
    return layers


def load_torch_state_dict(state_dict, cfg: QwenConfig, prefix: str = "model.",
                          dtype=None, device=None) -> QwenModel:
    """The decoder from an HF state dict (torch or numpy values), unfused:
    the port of ``chatts_tpu.models.qwen.load_torch_state_dict``.

    HF names (reference weight-prefix contract: chatts_vllm.py:467-470):
      model.embed_tokens.weight, model.layers.{i}.self_attn.{q,k,v,o}_proj.*,
      model.layers.{i}.mlp.{gate,up,down}_proj.weight,
      model.layers.{i}.{input,post_attention}_layernorm.weight,
      model.layers.{i}.self_attn.{q,k}_norm.weight (Qwen3),
      model.norm.weight, lm_head.weight (absent when embeddings are tied --
      reference: chatts_vllm.py:621-624).
    HF's (out, in) weights become (in, out) kernels; every tensor is cast to
    ``dtype`` (the config's by default)."""
    if dtype is None:
        dtype = getattr(torch, cfg.dtype)

    def get(name: str) -> torch.Tensor:
        return state_tensor(state_dict, name, device).to(dtype)

    def dense(name: str, bias: bool) -> Dense:
        b = get(name + ".bias") if bias and name + ".bias" in state_dict else None
        return Dense(get(name + ".weight").t().contiguous(), bias=b)

    layers = build_layers(cfg, get, dense, prefix)
    lm_head = None
    if not cfg.tie_word_embeddings and "lm_head.weight" in state_dict:
        lm_head = get("lm_head.weight").t().contiguous()
    return QwenModel(cfg, get(prefix + "embed_tokens.weight"), layers,
                     get(prefix + "norm.weight"), lm_head=lm_head)
