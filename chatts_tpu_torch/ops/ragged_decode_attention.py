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
``<wrapper>.launches`` counts the wrapper's calls that launched its kernel
(one a call, whatever the number of CUDA launches behind it).

Both kernels split the KV axis over blocks and merge the parts by
logsumexp (``csrc/decode_split.cuh``).  ``split_plan`` makes the plan from
the shapes alone, so the wrappers never read ``lengths`` on the host, and
``ragged_decode_attention_split_reference`` and
``ragged_decode_attention_int8_split_reference`` are the plain versions of
that arithmetic, for the tests and the card's checks; the port never calls
them.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from chatts_tpu_torch.kernels import build
from chatts_tpu_torch.ops.attention import NEG_INF

_SIGNATURES = {
    "chatts_ragged_decode_attention": (
        ctypes.c_int,
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    ),
}
_SIGNATURES_INT8 = {
    "chatts_ragged_decode_attention_int8": (
        ctypes.c_int,
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    ),
}

HEAD_DIM = 128
MAX_GROUP = 16
KEY_TILE = 128  # a chunk is a multiple of this many keys (decode_split.cuh)
MAX_BLOCKS = 8 * 132  # blocks in the grid: eight for each of the H100's SMs
MAX_SPLITS = 24  # the merge walks a row's parts one after another


def split_plan(s: int, b: int, kvh: int) -> Tuple[int, int]:
    """(splits, chunk) for a cache of capacity ``s``, from the shapes alone:
    the lengths stay on the device.

    The rows are usually far shorter than the capacity and a block past its
    row's length costs next to nothing, so the chunk is one key tile (each of
    a block's four warps then walks 32 keys), and longer only where the grid
    of splits x KVH x B blocks would pass MAX_BLOCKS or a row would have more
    than MAX_SPLITS parts to merge (the merge walks them in order; on an
    H100 one row of 6,001 keys at capacity 6,144 takes 0.021 ms in 24 parts,
    SDPA's time, and took longer in 48).  No split starts past the
    capacity."""
    tiles = -(-s // KEY_TILE)
    want = max(1, min(tiles, MAX_SPLITS, MAX_BLOCKS // (b * kvh)))
    chunk = -(-tiles // want) * KEY_TILE
    return -(-s // chunk), chunk


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


def _split_reference(q, k_cache, v_cache, lengths, k_scale, v_scale, chunk, scale):
    """The split kernels' arithmetic: per chunk of ``chunk`` keys and per head
    a max, a sum of p and an unnormalised accumulator over the chunk's keys
    below the row's length, merged by logsumexp in chunk order.  With scales
    (the int8 cache) the K scale multiplies the scores and the V scale
    multiplies p before the PV product; the sum of p is taken without it."""
    b, h, d = q.shape
    _, kvh, s, _ = k_cache.shape
    if scale is None:
        scale = d ** -0.5
    if chunk is None:
        chunk = split_plan(s, b, kvh)[1]
    qg = q.float().reshape(b, kvh, h // kvh, d) * scale
    out = torch.zeros((b, kvh, h // kvh, d), dtype=torch.float32, device=q.device)
    for bi in range(b):
        length = min(max(int(lengths[bi]), 0), s)
        parts = []
        for begin in range(0, s, chunk):
            if begin >= length:
                break
            end = min(begin + chunk, length)
            sc = torch.einsum("kgd,ksd->kgs", qg[bi], k_cache[bi, :, begin:end].float())
            if k_scale is not None:
                sc = sc * k_scale[bi, :, None, begin:end]
            m = sc.amax(dim=-1)
            p = torch.exp(sc - m[..., None])
            l = p.sum(dim=-1)
            if v_scale is not None:
                p = p * v_scale[bi, :, None, begin:end]
            parts.append((m, l, torch.einsum("kgs,ksd->kgd", p,
                                             v_cache[bi, :, begin:end].float())))
        if not parts:
            continue
        m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        l_sum = torch.zeros_like(m_all)
        acc_sum = torch.zeros_like(out[bi])
        for m, l, acc in parts:
            w = torch.exp(m - m_all)
            l_sum = l_sum + l * w
            acc_sum = acc_sum + acc * w[..., None]
        out[bi] = acc_sum / torch.where(l_sum > 0, l_sum, 1.0)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


def ragged_decode_attention_split_reference(
    q: torch.Tensor,  # (B, H, D)
    k_cache: torch.Tensor,  # (B, KVH, S, D)
    v_cache: torch.Tensor,  # (B, KVH, S, D)
    lengths: torch.Tensor,  # (B,) int
    *,
    chunk: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The split kernel's arithmetic in plain PyTorch.

    Each chunk of ``chunk`` keys gives, per head, a max, a sum of p and an
    unnormalised accumulator over its keys below the row's length; a chunk
    that starts at or past the length gives no part.  The parts are merged by
    logsumexp in chunk order; a row of length 0 has none and gives 0.
    ``chunk`` defaults to ``split_plan``'s."""
    return _split_reference(q, k_cache, v_cache, lengths, None, None, chunk, scale)


def _check(q, k_cache, v_cache, lengths, scales=(), *,
           what="ragged_decode_attention", cache_dtype=torch.bfloat16) -> None:
    build.refuse_gradients(what, q, k_cache, v_cache, *scales)
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


def _workspace(q, kvh: int, s: int, plan: Tuple[int, int], what: str):
    """The f32 workspace for the parts of ``plan``'s splits: per (row, kv
    head, split, head) an accumulator of 128 f32, a max and a sum
    (decode_split.cuh); None with one split.  Raises for a plan that does not
    cover the capacity ``s``."""
    splits, chunk = plan
    if (chunk < KEY_TILE or chunk % KEY_TILE or splits < 1
            or not (splits - 1) * chunk < s <= splits * chunk):
        raise ValueError(f"{what}: plan {plan} does not cover capacity {s}")
    if splits == 1:
        return None
    b, h, _ = q.shape
    return torch.empty(b * kvh * splits * (h // kvh) * (HEAD_DIM + 2),
                       dtype=torch.float32, device=q.device)


def ragged_decode_attention_on_plan(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    plan: Tuple[int, int],
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the kernel with ``plan`` = (splits, chunk) for CUDA tensors
    (``ragged_decode_attention`` takes ``split_plan``'s; this entry lets the
    card's tests and ``chip_smoke.py`` hold and time other chunks).  Nothing
    here reads ``lengths`` on the host."""
    if q.device.type != "cuda":
        raise ValueError(f"ragged_decode_attention: no kernel for device {q.device}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    _check(q, k_cache, v_cache, lengths)
    b, h, _ = q.shape
    _, kvh, s, _ = k_cache.shape
    splits, chunk = plan
    out = torch.empty_like(q)
    workspace = _workspace(q, kvh, s, plan, "ragged_decode_attention")
    lib = build.load("ragged_decode_attention", _SIGNATURES)
    err = lib.chatts_ragged_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), None if workspace is None else workspace.data_ptr(),
        b, h, kvh, s, float(scale), splits, chunk, build.stream_handle(q.device),
    )
    ragged_decode_attention.launches += 1
    build.check_launch(err, "ragged_decode_attention")
    return out


def ragged_decode_attention(
    q: torch.Tensor,  # (B, H, D) one token per row
    k_cache: torch.Tensor,  # (B, KVH, S, D) head-major
    v_cache: torch.Tensor,  # (B, KVH, S, D)
    lengths: torch.Tensor,  # (B,) int32, inclusive of the token just written
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Returns (B, H, D) in q's type."""
    build.refuse_gradients("ragged_decode_attention", q, k_cache, v_cache)
    if q.device.type == "cpu":
        return ragged_decode_attention_reference(q, k_cache, v_cache, lengths, scale=scale)
    _, kvh, s, _ = k_cache.shape
    return ragged_decode_attention_on_plan(
        q, k_cache, v_cache, lengths, split_plan(s, q.shape[0], kvh), scale=scale)


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


def ragged_decode_attention_int8_split_reference(
    q: torch.Tensor,  # (B, H, D)
    k_cache: torch.Tensor,  # (B, KVH, S, D) int8
    v_cache: torch.Tensor,  # (B, KVH, S, D) int8
    k_scale: torch.Tensor,  # (B, KVH, S) f32
    v_scale: torch.Tensor,  # (B, KVH, S) f32
    lengths: torch.Tensor,  # (B,) int
    *,
    chunk: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The int8 split kernel's arithmetic in plain PyTorch: the parts and the
    merge of ``ragged_decode_attention_split_reference`` with the K scale on
    the scores and the V scale on p before the PV product.  ``chunk``
    defaults to ``split_plan``'s."""
    return _split_reference(q, k_cache, v_cache, lengths, k_scale, v_scale, chunk, scale)


def ragged_decode_attention_int8_on_plan(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    lengths: torch.Tensor,
    plan: Tuple[int, int],
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the int8 kernel with ``plan`` = (splits, chunk) for CUDA tensors
    (``ragged_decode_attention_int8`` takes ``split_plan``'s; this entry lets
    the card's tests and ``chip_smoke.py`` hold and time other chunks).
    Nothing here reads ``lengths`` on the host, so a call can be captured in
    a CUDA graph."""
    what = "ragged_decode_attention_int8"
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    _check(q, k_cache, v_cache, lengths, (k_scale, v_scale), what=what,
           cache_dtype=torch.int8)
    b, h, _ = q.shape
    _, kvh, s, _ = k_cache.shape
    splits, chunk = plan
    out = torch.empty_like(q)
    workspace = _workspace(q, kvh, s, plan, what)
    lib = build.load("ragged_decode_attention_int8", _SIGNATURES_INT8)
    err = lib.chatts_ragged_decode_attention_int8(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if workspace is None else workspace.data_ptr(),
        b, h, kvh, s, float(scale), splits, chunk, build.stream_handle(q.device),
    )
    ragged_decode_attention_int8.launches += 1
    build.check_launch(err, what)
    return out


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
    build.refuse_gradients("ragged_decode_attention_int8", q, k_scale, v_scale)
    if q.device.type == "cpu":
        return ragged_decode_attention_int8_reference(
            q, k_cache, v_cache, k_scale, v_scale, lengths, scale=scale)
    _, kvh, s, _ = k_cache.shape
    return ragged_decode_attention_int8_on_plan(
        q, k_cache, v_cache, k_scale, v_scale, lengths, split_plan(s, q.shape[0], kvh),
        scale=scale)


ragged_decode_attention_int8.launches = 0


# ---------------------------------------------------------------------------
# Tensor parallelism: the port of ``ragged_decode_attention_tp`` and
# ``ragged_decode_attention_int8_tp``.  JAX's shard_map splits the kv-head
# axis over tp (queries ride along with their head group) and the rows over
# dp, and runs the single-device kernel on each shard; here each rank holds
# its shard already (``parallel/sharding.py``), so the wrappers run B2 or B4
# on it.  Attention never mixes heads or rows, so there is no collective:
# o_proj's row-parallel product reduces afterwards.
# ---------------------------------------------------------------------------

def supported_tp(mesh, batch: int, kv_heads: int, num_heads: int) -> bool:
    """Whether the (dp, tp) mesh divides the whole decode attention's grid
    (``batch`` rows, ``kv_heads`` and ``num_heads`` heads): JAX's rule, and
    the port's own, at most MAX_GROUP query heads a kv head."""
    tp = mesh.shape.get("tp", 1)
    dp = mesh.shape.get("dp", 1)
    return (kv_heads % tp == 0 and num_heads % tp == 0 and batch % dp == 0
            and num_heads % kv_heads == 0 and num_heads // kv_heads <= MAX_GROUP)


def _check_tp(mesh, q: torch.Tensor, k_cache: torch.Tensor, what: str) -> None:
    b, h, _ = q.shape
    kvh = k_cache.shape[1]
    if not supported_tp(mesh, b * mesh.dp, kvh * mesh.tp, h * mesh.tp):
        raise ValueError(f"{what}: a shard of {b} rows, {h} heads over {kvh} kv heads "
                         f"does not come from a (dp {mesh.dp}, tp {mesh.tp}) split")


def ragged_decode_attention_tp(
    q: torch.Tensor,  # (B/dp, H/tp, D): this rank's rows and heads
    k_cache: torch.Tensor,  # (B/dp, KVH/tp, S, D)
    v_cache: torch.Tensor,  # (B/dp, KVH/tp, S, D)
    lengths: torch.Tensor,  # (B/dp,) int32
    *,
    mesh,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """This rank's (B/dp, H/tp, D) share of the decode attention."""
    _check_tp(mesh, q, k_cache, "ragged_decode_attention_tp")
    return ragged_decode_attention(q, k_cache, v_cache, lengths, scale=scale)


def ragged_decode_attention_int8_tp(
    q: torch.Tensor,  # (B/dp, H/tp, D)
    k_cache: torch.Tensor,  # (B/dp, KVH/tp, S, D) int8
    v_cache: torch.Tensor,  # (B/dp, KVH/tp, S, D) int8
    k_scale: torch.Tensor,  # (B/dp, KVH/tp, S) f32
    v_scale: torch.Tensor,  # (B/dp, KVH/tp, S) f32
    lengths: torch.Tensor,  # (B/dp,) int32
    *,
    mesh,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """This rank's (B/dp, H/tp, D) share of the int8-cache decode attention."""
    _check_tp(mesh, q, k_cache, "ragged_decode_attention_int8_tp")
    return ragged_decode_attention_int8(q, k_cache, v_cache, k_scale, v_scale, lengths,
                                        scale=scale)
