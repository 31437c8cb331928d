"""Multi-head latent attention (MLA, DeepSeek-V2/V3's attention): the CUDA
kernels ``csrc/mla_decode.cu`` (absorbed decode over the latent cache) and
the MLA instance of ``csrc/flash_attention.cu`` (prefill at qk 192 / v 128),
each with its plain PyTorch version.

A latent cache row is a token's normed ``c_kv`` (``LATENT`` wide) and its
roped key (``ROPE`` wide), shared by every head; ``kv_b`` maps ``c_kv`` to
each head's ``NOPE``-wide key and ``V``-wide value.

- ``mla_prefill``: a prompt block attends itself, un-absorbed: q and k are
  (nope ‖ rope) per head, 192 wide, v 128 wide, the position mask of
  ``ops/attention.py``.  The kernel is B1 (``flash_attention.cu``) made
  generic over (qk, v) widths; its 128 / 128 instance is the one the Qwen
  path runs.
- ``mla_decode``: each query row attends the first ``lengths[r]`` positions
  of cache row ``rows[r]`` in the absorbed form: its q_nope is taken through
  ``w_uk`` (kv_b's key half, per head (NOPE, LATENT)) into the latent, so
  every head scores over the whole 576-wide row; the output is taken over
  the 512-wide ``c_kv`` and brought up through ``w_uv`` (kv_b's value half,
  per head (LATENT, V)).  A decode step gives one query a slot
  (``rows = arange(B)``); the serving engine's mixed step adds its prompt
  tokens, each a query of its own over its slot's prefix.  The attention
  splits the positions over blocks and merges the parts by logsumexp
  (``csrc/decode_split.cuh``, as B2 does); ``split_plan`` makes the plan
  from the shapes alone.

Each wrapper runs the plain version for CPU tensors and the kernels for
CUDA tensors; a CUDA call the kernels do not take raises.
``<wrapper>.launches`` counts the calls that launched kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from chatts_tpu_torch.kernels import build
from chatts_tpu_torch.ops.attention import NEG_INF

LATENT = 512
ROPE = 64
NOPE = 128
V = 128
HEADS = 16  # the decode kernel's heads: one m16 tile of the tensor cores
KEY_TILE = 128  # a split's chunk is a multiple of this many keys (decode_split.cuh)
MAX_SPLITS = 16
MAX_PARTS = 4096  # query rows x splits, the grid of the split kernel

_DECODE_SIGNATURES = {
    "chatts_mla_bmm": (ctypes.c_int, [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p]),
    "chatts_mla_decode": (ctypes.c_int, [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                          + [ctypes.c_float, ctypes.c_void_p]),
}
_PREFILL_SIGNATURES = {
    "chatts_mla_prefill": (
        ctypes.c_int,
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    ),
}


# -- prefill ------------------------------------------------------------------

def mla_prefill_reference(q, k, v, *, q_positions, kv_positions, kv_valid,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: q (B, T, H, Dqk), k (B, S, H, Dqk), v (B, S, H, Dv);
    scores and softmax in f32, p rounded to v's type for the PV product (as
    ``mha_reference``), a row with no visible key 0.  Returns (B, T, H, Dv)
    in q's type."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    mask = kv_valid[:, None, :] & (kv_positions[:, None, :] <= q_positions[:, :, None])
    scores = torch.where(mask[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(dim=-1)[:, None, :, None], probs, 0.0)
    out = torch.einsum("bhts,bshd->bthd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _check_prefill(q, k, v, q_positions, kv_positions, kv_valid) -> None:
    b, t, h, dqk = q.shape
    s = k.shape[1]
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("mla_prefill: the kernel takes bf16")
    if dqk != NOPE + ROPE or k.shape != (b, s, h, dqk) or v.shape != (b, s, h, V):
        raise ValueError(f"mla_prefill: the kernel takes q/k (.., {NOPE + ROPE}) and v "
                         f"(.., {V}), got q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if t < 1 or s < 1:
        raise ValueError("mla_prefill: T and S must be at least 1")
    if (q_positions.shape != (b, t) or q_positions.dtype != torch.int32
            or kv_positions.shape != (b, s) or kv_positions.dtype != torch.int32
            or kv_valid.shape != (b, s) or kv_valid.dtype != torch.bool):
        raise ValueError("mla_prefill: positions (B, T) and (B, S) int32, kv_valid (B, S) bool")
    for x in (q, k, v, q_positions, kv_positions, kv_valid):
        if not x.is_contiguous() or x.device != q.device:
            raise ValueError("mla_prefill: inputs must be contiguous, on one device")


def mla_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                q_positions: torch.Tensor, kv_positions: torch.Tensor,
                kv_valid: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """Prefill attention at qk width Dqk and v width Dv: q (B, T, H, Dqk),
    k (B, S, H, Dqk), v (B, S, H, Dv) -> (B, T, H, Dv) in q's type; query i
    attends key j when kv_valid[j] and kv_positions[j] <= q_positions[i]."""
    build.refuse_gradients("mla_prefill", q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return mla_prefill_reference(q, k, v, q_positions=q_positions,
                                     kv_positions=kv_positions, kv_valid=kv_valid, scale=scale)
    _check_prefill(q, k, v, q_positions, kv_positions, kv_valid)
    from chatts_tpu_torch.ops.flash_attention import default_block_q

    b, t, h, _ = q.shape
    s = k.shape[1]
    out = torch.empty((b, t, h, V), dtype=q.dtype, device=q.device)
    lib = build.load("flash_attention", _PREFILL_SIGNATURES)
    err = lib.chatts_mla_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
        kv_positions.data_ptr(), kv_valid.data_ptr(), out.data_ptr(), b, t, s, h, h,
        float(scale), default_block_q(t), build.stream_handle(q.device))
    mla_prefill.launches += 1
    build.check_launch(err, "mla_prefill")
    return out


mla_prefill.launches = 0


# -- decode -------------------------------------------------------------------

def split_plan(s: int, r: int) -> Tuple[int, int]:
    """(splits, chunk) of the decode kernel for a cache of capacity ``s`` and
    ``r`` query rows, from the shapes alone: the lengths stay on the device.
    A block takes ``chunk`` positions of one row (a multiple of KEY_TILE);
    at most MAX_SPLITS parts a row, and no more than MAX_PARTS blocks in
    all.  A block past its row's length returns at once."""
    tiles = -(-s // KEY_TILE)
    want = max(1, min(tiles, MAX_SPLITS, MAX_PARTS // max(r, 1)))
    chunk = -(-tiles // want) * KEY_TILE
    return -(-s // chunk), chunk


def _latent_rows(cache: torch.Tensor) -> torch.Tensor:
    """The cache (B, 1, S, L) or (B, S, L) as (B, S, L)."""
    return cache.reshape(cache.shape[0], cache.shape[-2], cache.shape[-1])


def mla_decode_reference(q_nope, q_pe, w_uk, w_uv, cache, rows, lengths,
                         scale: float) -> torch.Tensor:
    """Plain version of the kernels' arithmetic: q_nope (R, H, NOPE) through
    w_uk (H, NOPE, LATENT) in f32, rounded to q's type, beside q_pe (R, H,
    ROPE); scores over cache row ``rows[r]``'s first ``lengths[r]`` positions
    in f32; p rounded to q's type for the product with the positions'
    ``c_kv``, the denominator from the unrounded p; that output rounded to
    q's type, then through w_uv (H, LATENT, V) in f32, rounded.  Returns
    (R, H, V)."""
    dt = q_nope.dtype
    c = _latent_rows(cache)
    latent = w_uk.shape[-1]
    q_lat = torch.einsum("rhn,hnl->rhl", q_nope.float(), w_uk.float()).to(dt)
    q = torch.cat([q_lat, q_pe.to(dt)], dim=-1).float()
    kv = c.index_select(0, rows.long()).float()  # (R, S, L)
    scores = torch.einsum("rhd,rsd->rhs", q, kv) * scale
    valid = torch.arange(c.shape[1], device=q.device)[None, :] < lengths.long()[:, None]
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid[:, None, :], torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("rhs,rsl->rhl", p.to(dt).float(), kv[..., :latent])
    o = (o / torch.where(l > 0, l, 1.0)).to(dt)
    return torch.einsum("rhl,hlv->rhv", o.float(), w_uv.float()).to(dt)


def _check_decode(q_nope, q_pe, w_uk, w_uv, cache, rows, lengths) -> None:
    r, h, _ = q_nope.shape
    c = _latent_rows(cache)
    if any(x.dtype != torch.bfloat16 for x in (q_nope, q_pe, w_uk, w_uv, c)):
        raise ValueError("mla_decode: the kernels take bf16")
    if (h != HEADS or q_nope.shape != (r, h, NOPE) or q_pe.shape != (r, h, ROPE)
            or w_uk.shape != (h, NOPE, LATENT) or w_uv.shape != (h, LATENT, V)
            or c.shape[-1] != LATENT + ROPE):
        raise ValueError(f"mla_decode: the kernels take {HEADS} heads, nope {NOPE}, rope {ROPE}, "
                         f"latent {LATENT}, v {V}; got q_nope {tuple(q_nope.shape)} "
                         f"cache {tuple(cache.shape)}")
    if rows.shape != (r,) or lengths.shape != (r,) or rows.dtype != torch.int32 \
            or lengths.dtype != torch.int32:
        raise ValueError("mla_decode: rows and lengths must be (R,) int32")
    if not c.is_contiguous() or not w_uk.is_contiguous() or not w_uv.is_contiguous():
        raise ValueError("mla_decode: the cache and the factors must be contiguous")


def _bmm(lib, x: torch.Tensor, w: torch.Tensor, y: torch.Tensor, ldx: int, ldy: int) -> None:
    """y[r, h, :N] = x[r, h, :K] @ w[h] (bf16, f32 sums), rows ldx and ldy
    elements apart per (r, h)."""
    r, h = x.shape[0], w.shape[0]
    err = lib.chatts_mla_bmm(x.data_ptr(), w.data_ptr(), y.data_ptr(), r, h, w.shape[1],
                             w.shape[2], ldx, ldy, build.stream_handle(x.device))
    build.check_launch(err, "mla_decode (bmm)")


def mla_decode(q_nope: torch.Tensor, q_pe: torch.Tensor, w_uk: torch.Tensor,
               w_uv: torch.Tensor, cache: torch.Tensor, rows: torch.Tensor,
               lengths: torch.Tensor, *, scale: float) -> torch.Tensor:
    """Absorbed latent attention of R query rows (see the module's
    docstring): q_nope (R, H, NOPE), q_pe (R, H, ROPE) roped, cache (B, 1,
    S, LATENT + ROPE), rows and lengths (R,) int.  Returns (R, H, V) in
    q's type."""
    build.refuse_gradients("mla_decode", q_nope, q_pe)
    if q_nope.device.type == "cpu":
        return mla_decode_reference(q_nope, q_pe, w_uk, w_uv, cache, rows, lengths, scale)
    rows, lengths = rows.to(torch.int32), lengths.to(torch.int32)
    _check_decode(q_nope, q_pe, w_uk, w_uv, cache, rows, lengths)
    r, h, _ = q_nope.shape
    c = _latent_rows(cache)
    s = c.shape[1]
    dev = q_nope.device
    lib = build.load("mla_decode", _DECODE_SIGNATURES)
    q = torch.empty((r, h, LATENT + ROPE), dtype=q_nope.dtype, device=dev)
    q_nope = q_nope.contiguous()
    _bmm(lib, q_nope, w_uk, q, NOPE, LATENT + ROPE)
    q[..., LATENT:] = q_pe
    splits, chunk = split_plan(s, r)
    # Per part (query row, split): the merge's 64 heads of 128 (a head's
    # 512 as four) of f32 sums, then a (max, sum) pair for each of them.
    parts = r * splits * h * (LATENT // 128)
    ws = torch.empty((parts * 130,), dtype=torch.float32, device=dev)
    o = torch.empty((r, h, LATENT), dtype=q.dtype, device=dev)
    err = lib.chatts_mla_decode(q.data_ptr(), c.data_ptr(), rows.data_ptr(), lengths.data_ptr(),
                                ws.data_ptr(), o.data_ptr(), r, s, splits, chunk, float(scale),
                                build.stream_handle(dev))
    build.check_launch(err, "mla_decode")
    out = torch.empty((r, h, V), dtype=q.dtype, device=dev)
    _bmm(lib, o, w_uv, out, LATENT, V)
    mla_decode.launches += 1
    return out


mla_decode.launches = 0
