"""Prefill attention: the CUDA kernel ``csrc/flash_attention.cu`` and its
plain PyTorch version.

Replaces ``chatts_tpu/ops/flash_attention.py::flash_attention``.  The kernel
takes bf16 with head_dim 128 (the main path's width) at any T and S; the
source's header says what bounds it on the H100 and how it is laid out.

``flash_attention`` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; a CUDA call the kernel does not take raises.
``flash_attention.launches`` counts the kernel's launches.

``flash_attention_tiled_reference`` is the plain version of the kernel's own
arithmetic (the tile loop, both skip rules, the finite sentinel of the
running max, p rounded for the PV product and the denominator from the
unrounded p), for the tests and the card's checks; the port never calls it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from chatts_tpu_torch.kernels import build
from chatts_tpu_torch.ops.attention import mha_reference

_SIGNATURES = {
    "chatts_flash_attention": (
        ctypes.c_int,
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    ),
}

HEAD_DIM = 128
BLOCK_K = 64  # keys a tile, in the kernel
BLOCKS_Q = (64, 128)  # the query tiles the kernel has


def default_block_q(t: int) -> int:
    """The kernel's query tile for T rows: 128, or 64 where T fits in one.

    On an H100 (80GB HBM3, 700 W; ``chip_smoke.py`` phase 2, B4 H40 KVH8
    D128) the 128-row tile took 0.246 ms against 0.290 ms at T = S = 1152 and
    was the faster at every T above 64 that was timed (it reads k and v from
    shared memory half as often per MMA); at T = 37 the 64-row tile took
    0.005 ms against 0.008 ms, since most of a 128-row tile is padding."""
    return 64 if t <= 64 else 128


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    kv_valid: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's plain version: it computes ``mha_reference``."""
    return mha_reference(
        q, k, v, q_positions=q_positions, kv_positions=kv_positions,
        kv_valid=kv_valid, scale=scale,
    )


def flash_attention_tiled_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    kv_valid: torch.Tensor,
    scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_k: int = BLOCK_K,
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, tile by tile.

    For each tile of ``block_q`` queries the key tiles are walked in order.
    A key tile is skipped when none of its keys is valid or the smallest
    position among its valid keys is above the largest query position of the
    query tile.  The running max starts at float32's minimum (finite), so a
    row whose tiles so far were wholly masked scales by exp(0) = 1, and p is
    zeroed by the mask, not by the exponential.  p is rounded to v's type for
    the PV product; the denominator sums the unrounded p.  ``stats``, if
    given, receives the counts of key tiles visited and skipped."""
    b, t, h, d = q.shape
    _, s, kvh, _ = k.shape
    g = h // kvh
    if scale is None:
        scale = d ** -0.5
    if block_q is None:
        block_q = default_block_q(t)
    neg = torch.finfo(torch.float32).min
    out = torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device)
    visited = skipped = 0
    for bi in range(b):
        for q0 in range(0, t, block_q):
            q1 = min(q0 + block_q, t)
            qp = q_positions[bi, q0:q1]
            qt = q[bi, q0:q1].float().reshape(q1 - q0, kvh, g, d)
            m = torch.full((kvh, g, q1 - q0), neg, dtype=torch.float32, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros((kvh, g, q1 - q0, d), dtype=torch.float32, device=q.device)
            for k0 in range(0, s, block_k):
                k1 = min(k0 + block_k, s)
                kp, ok = kv_positions[bi, k0:k1], kv_valid[bi, k0:k1]
                if not bool(ok.any()) or int(kp[ok].min()) > int(qp.max()):
                    skipped += 1
                    continue
                visited += 1
                sc = torch.einsum("tkgd,skd->kgts", qt, k[bi, k0:k1].float()) * scale
                mask = ok[None, :] & (kp[None, :] <= qp[:, None])
                sc = torch.where(mask, sc, neg)
                m_new = torch.maximum(m, sc.amax(dim=-1))
                alpha = torch.exp(m - m_new)
                p = torch.where(mask, torch.exp(sc - m_new[..., None]), 0.0)
                l = l * alpha + p.sum(dim=-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "kgts,skd->kgtd", p.to(v.dtype).float(), v[bi, k0:k1].float())
                m = m_new
            res = acc / torch.where(l > 0, l, 1.0)[..., None]
            out[bi, q0:q1] = res.permute(2, 0, 1, 3).reshape(q1 - q0, h, d)
    if stats is not None:
        stats.update(tiles_visited=visited, tiles_skipped=skipped)
    return out.to(q.dtype)


def _check(q, k, v, q_positions, kv_positions, kv_valid) -> None:
    build.refuse_gradients("flash_attention", q, k, v)
    b, t, h, d = q.shape
    _, s, kvh, _ = k.shape
    tensors = (q, k, v, q_positions, kv_positions, kv_valid)
    if any(x.device != q.device for x in tensors):
        raise ValueError("flash_attention: all inputs must be on one device")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: the kernel takes bf16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d != HEAD_DIM:
        raise ValueError(f"flash_attention: the kernel takes head_dim {HEAD_DIM}, got {d}")
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d or h % kvh:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if t < 1 or s < 1:
        raise ValueError("flash_attention: T and S must be at least 1")
    if q_positions.shape != (b, t) or q_positions.dtype != torch.int32:
        raise ValueError("flash_attention: q_positions must be (B, T) int32")
    if kv_positions.shape != (b, s) or kv_positions.dtype != torch.int32:
        raise ValueError("flash_attention: kv_positions must be (B, S) int32")
    if kv_valid.shape != (b, s) or kv_valid.dtype != torch.bool:
        raise ValueError("flash_attention: kv_valid must be (B, S) bool")
    for x in tensors:
        if not x.is_contiguous():
            raise ValueError("flash_attention: inputs must be contiguous")
    for x in (q, k, v):
        if x.data_ptr() % 16:
            raise ValueError("flash_attention: q, k, v must be 16-byte aligned")


def flash_attention_on_tile(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    kv_valid: torch.Tensor,
    block_q: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the kernel with a query tile of ``block_q`` rows for CUDA
    tensors (``flash_attention`` picks the tile by T; this entry lets the
    card's tests and ``chip_smoke.py`` hold and time both)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if block_q not in BLOCKS_Q:
        raise ValueError(f"flash_attention: no query tile of {block_q} rows")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    _check(q, k, v, q_positions, kv_positions, kv_valid)
    b, t, h, _ = q.shape
    _, s, kvh, _ = k.shape
    out = torch.empty_like(q)
    lib = build.load("flash_attention", _SIGNATURES)
    err = lib.chatts_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q_positions.data_ptr(), kv_positions.data_ptr(), kv_valid.data_ptr(),
        out.data_ptr(), b, t, s, h, kvh, float(scale), block_q,
        build.stream_handle(q.device),
    )
    flash_attention.launches += 1
    build.check_launch(err, "flash_attention")
    return out


def flash_attention(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, S, KVH, D)
    v: torch.Tensor,  # (B, S, KVH, D)
    *,
    q_positions: torch.Tensor,  # (B, T) int32
    kv_positions: torch.Tensor,  # (B, S) int32
    kv_valid: torch.Tensor,  # (B, S) bool
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Returns (B, T, H, D) in q's type."""
    build.refuse_gradients("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, q_positions=q_positions, kv_positions=kv_positions,
            kv_valid=kv_valid, scale=scale,
        )
    return flash_attention_on_tile(
        q, k, v, q_positions=q_positions, kv_positions=kv_positions,
        kv_valid=kv_valid, block_q=default_block_q(q.shape[1]), scale=scale,
    )


flash_attention.launches = 0
