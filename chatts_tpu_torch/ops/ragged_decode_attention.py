"""Decode attention over a head-major KV cache: the CUDA kernels
``csrc/ragged_decode_attention.cu`` (bf16 cache) and
``csrc/ragged_decode_attention_int8.cu`` (int8 cache), each with its plain
PyTorch version.

Replaces ``chatts_tpu/ops/ragged_decode_attention.py::ragged_decode_attention``
and ``::ragged_decode_attention_int8``.  Each batch row's single query
attends the first ``lengths[b]`` positions of its cache row; the kernels read
only those.  They take head_dim 128 and at most 16 query heads per kv head,
at any cache capacity S; each source's header says what bounds it on the
H100.

Each wrapper runs the plain version for CPU tensors and launches its kernel
for CUDA tensors; a CUDA call the kernel does not take raises.
``<wrapper>.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from chatts_tpu_torch.kernels import build
from chatts_tpu_torch.ops.attention import NEG_INF

_SIGNATURES = {
    "chatts_ragged_decode_attention": (
        ctypes.c_int,
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p],
    ),
}
_SIGNATURES_INT8 = {
    "chatts_ragged_decode_attention_int8": (
        ctypes.c_int,
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p],
    ),
}

HEAD_DIM = 128
MAX_GROUP = 16


def ragged_decode_attention_reference(
    q: torch.Tensor,  # (B, H, D)
    k_cache: torch.Tensor,  # (B, KVH, S, D)
    v_cache: torch.Tensor,  # (B, KVH, S, D)
    lengths: torch.Tensor,  # (B,) int
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version: dense masked attention over the whole capacity.  The
    query is scaled in f32 before the dot and p stays f32, as in the kernel."""
    b, h, d = q.shape
    _, kvh, s, _ = k_cache.shape
    if scale is None:
        scale = d ** -0.5
    qg = q.float().reshape(b, kvh, h // kvh, d) * scale
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float())
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None]  # (B, S)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(valid.any(dim=-1)[:, None, None, None], probs, 0.0)
    out = torch.einsum("bkgs,bksd->bkgd", probs, v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)


def _check(q, k_cache, v_cache, lengths, scales=(), *,
           what="ragged_decode_attention", cache_dtype=torch.bfloat16) -> None:
    b, h, d = q.shape
    tensors = (q, k_cache, v_cache, lengths, *scales)
    if any(x.device != q.device for x in tensors):
        raise ValueError(f"{what}: all inputs must be on one device")
    if (q.dtype != torch.bfloat16 or k_cache.dtype != cache_dtype
            or v_cache.dtype != cache_dtype):
        raise ValueError(f"{what}: the kernel takes a bf16 query and a {cache_dtype} cache")
    if d != HEAD_DIM:
        raise ValueError(f"{what}: the kernel takes head_dim {HEAD_DIM}")
    if (k_cache.dim() != 4 or v_cache.shape != k_cache.shape
            or k_cache.shape[0] != b or k_cache.shape[3] != d):
        raise ValueError(f"{what}: bad shapes q {tuple(q.shape)} "
                         f"cache {tuple(k_cache.shape)}")
    for x in scales:
        if x.shape != k_cache.shape[:3] or x.dtype != torch.float32:
            raise ValueError(f"{what}: scales must be (B, KVH, S) float32")
    kvh = k_cache.shape[1]
    if h % kvh or h // kvh > MAX_GROUP:
        raise ValueError(f"{what}: {h} heads over {kvh} kv heads "
                         f"(at most {MAX_GROUP} per kv head)")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"{what}: lengths must be (B,) int32")
    for x in tensors:
        if not x.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    for x in (q, k_cache, v_cache):
        if x.data_ptr() % 16:
            raise ValueError(f"{what}: q and the cache must be 16-byte aligned")


def ragged_decode_attention(
    q: torch.Tensor,  # (B, H, D) one token per row
    k_cache: torch.Tensor,  # (B, KVH, S, D) head-major
    v_cache: torch.Tensor,  # (B, KVH, S, D)
    lengths: torch.Tensor,  # (B,) int32, inclusive of the token just written
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Returns (B, H, D) in q's type."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return ragged_decode_attention_reference(q, k_cache, v_cache, lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_decode_attention: no kernel for device {q.device}")
    _check(q, k_cache, v_cache, lengths)
    b, h, _ = q.shape
    _, kvh, s, _ = k_cache.shape
    out = torch.empty_like(q)
    lib = build.load("ragged_decode_attention", _SIGNATURES)
    err = lib.chatts_ragged_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, h, kvh, s, float(scale), build.stream_handle(q.device),
    )
    ragged_decode_attention.launches += 1
    build.check_launch(err, "ragged_decode_attention")
    return out


ragged_decode_attention.launches = 0


def ragged_decode_attention_int8_reference(
    q: torch.Tensor,  # (B, H, D)
    k_cache: torch.Tensor,  # (B, KVH, S, D) int8
    v_cache: torch.Tensor,  # (B, KVH, S, D) int8
    k_scale: torch.Tensor,  # (B, KVH, S) f32
    v_scale: torch.Tensor,  # (B, KVH, S) f32
    lengths: torch.Tensor,  # (B,) int
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version, with the kernel's factored math: the K scale multiplies
    the scores and the V scale multiplies p before the PV product; neither
    touches the D axis.  Dense and masked over the whole capacity."""
    b, h, d = q.shape
    _, kvh, s, _ = k_cache.shape
    if scale is None:
        scale = d ** -0.5
    qg = q.float().reshape(b, kvh, h // kvh, d) * scale
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float()) * k_scale[:, :, None, :]
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None]  # (B, S)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(valid.any(dim=-1)[:, None, None, None], probs, 0.0)
    out = torch.einsum("bkgs,bksd->bkgd", probs * v_scale[:, :, None, :], v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)


def ragged_decode_attention_int8(
    q: torch.Tensor,  # (B, H, D) one token per row
    k_cache: torch.Tensor,  # (B, KVH, S, D) int8 codes
    v_cache: torch.Tensor,  # (B, KVH, S, D) int8 codes
    k_scale: torch.Tensor,  # (B, KVH, S) f32, one scale per position
    v_scale: torch.Tensor,  # (B, KVH, S) f32
    lengths: torch.Tensor,  # (B,) int32, inclusive of the token just written
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Returns (B, H, D) in q's type."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return ragged_decode_attention_int8_reference(
            q, k_cache, v_cache, k_scale, v_scale, lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_decode_attention_int8: no kernel for device {q.device}")
    _check(q, k_cache, v_cache, lengths, (k_scale, v_scale),
           what="ragged_decode_attention_int8", cache_dtype=torch.int8)
    b, h, _ = q.shape
    _, kvh, s, _ = k_cache.shape
    out = torch.empty_like(q)
    lib = build.load("ragged_decode_attention_int8", _SIGNATURES_INT8)
    err = lib.chatts_ragged_decode_attention_int8(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, h, kvh, s,
        float(scale), build.stream_handle(q.device),
    )
    ragged_decode_attention_int8.launches += 1
    build.check_launch(err, "ragged_decode_attention_int8")
    return out


ragged_decode_attention_int8.launches = 0
