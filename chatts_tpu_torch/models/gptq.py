"""GPTQ-Int4 checkpoints: the port's copy of ``chatts_tpu/models/gptq.py``.

The reference ships GPTQ-quantized variants (ChatTS-8B/14B-GPTQ-Int4,
reference: README.md:52,260-263). ``to_native_int4`` converts a GPTQ linear
losslessly to the port's int4 layout (``ops/int4_matmul.py``: nibble-packed
``kernel_q4`` and group-128 ``scales4``), with ``zeros4`` and ``perm4`` for
asymmetric and activation-order exports; ``load_gptq_kernel`` dequantizes
one to a dense kernel.

Format (AutoGPTQ v1, bits=4, the format of the published checkpoints):
  - ``qweight`` int32 (in/8, out): eight 4-bit codes packed per int32 along
    the input dimension, least-significant nibble first.
  - ``qzeros``  int32 (groups, out/8): packed 4-bit zero-points, stored
    MINUS ONE (the historical AutoGPTQ off-by-one: stored = zero - 1).
  - ``scales``  f16/f32 (groups, out).
  - ``g_idx``   int32 (in,): input-feature -> group map (present with
    desc_act; defaults to ``i // group_size``).
Dequantization: W[i, o] = scales[g_idx[i], o] * (code[i, o] - (qzeros+1)).

The numpy helpers are copies of the JAX package's. ``to_native_int4``
differs in one chosen way: the port's int4 kernels take group 128 only, so
an export of another group size (64, or ``group_size=-1``) gives None here,
and the loader dequantizes and requantizes it at group 128 (lossy), where
the JAX package imports any group its TPU tile planner fits.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from chatts_tpu_torch.models.qwen import state_tensor
from chatts_tpu_torch.ops.int4_matmul import DEFAULT_GROUP
from chatts_tpu_torch.parallel import sharding

BITS = 4
PACK = 32 // BITS  # codes per int32


def unpack_int4(packed: np.ndarray, axis: int) -> np.ndarray:
    """Unpack 4-bit codes from int32 along ``axis`` (LSB nibble first)."""
    packed = packed.astype(np.uint32)
    parts = [(packed >> (BITS * b)) & 0xF for b in range(PACK)]
    stacked = np.stack(parts, axis=axis + 1)  # (..., PACK, ...)
    shape = list(packed.shape)
    shape[axis] *= PACK
    return stacked.reshape(shape).astype(np.int32)


def pack_int4(codes: np.ndarray, axis: int) -> np.ndarray:
    """Inverse of :func:`unpack_int4` (used by tests / checkpoint synthesis)."""
    shape = list(codes.shape)
    assert shape[axis] % PACK == 0
    shape[axis] //= PACK
    grouped = codes.reshape(
        shape[:axis] + [shape[axis], PACK] + shape[axis + 1:]
    ).astype(np.uint32)
    out = np.zeros(shape, np.uint32)
    for b in range(PACK):
        out |= (np.take(grouped, b, axis=axis + 1) & 0xF) << (BITS * b)
    return out.astype(np.int32)


def dequantize(
    qweight: np.ndarray,  # int32 (in/8, out)
    qzeros: np.ndarray,  # int32 (groups, out/8)
    scales: np.ndarray,  # (groups, out)
    g_idx: Optional[np.ndarray] = None,  # int32 (in,)
    group_size: Optional[int] = None,
) -> np.ndarray:
    """Return the dense kernel W (in, out) float32."""
    codes = unpack_int4(qweight, axis=0)  # (in, out)
    zeros = unpack_int4(qzeros, axis=1) + 1  # (groups, out); undo the -1
    in_features = codes.shape[0]
    if g_idx is None:
        if group_size is None:
            group_size = in_features // scales.shape[0]
        g_idx = np.arange(in_features, dtype=np.int64) // group_size
    g_idx = np.asarray(g_idx, np.int64)
    scales = np.asarray(scales, np.float32)
    return scales[g_idx] * (codes.astype(np.float32) - zeros[g_idx])


def has_gptq_tensors(sd, name: str) -> bool:
    """Whether ``name`` (a linear layer prefix) is stored GPTQ-packed."""
    return name + ".qweight" in sd


def sd_shape(sd, key: str):
    """A tensor's shape, from the header where the state dict has one."""
    if hasattr(sd, "shape"):
        return tuple(sd.shape(key))
    return tuple(np.shape(sd[key]))


def native_codes(qweight: torch.Tensor) -> torch.Tensor:
    """GPTQ ``qweight`` (IN/8, OUT) int32 -> the port's packed (IN/2, OUT)
    int8, on qweight's device, with no unpacking: byte b of the word at
    (j, o) holds rows 8j+2b (low nibble) and 8j+2b+1 (high), the packed
    layout's byte row 4j+b holds the same two rows, and a code c in [0, 16)
    stored as the signed value c - 8 is c XOR 8 in four bits."""
    rows8, out_dim = qweight.shape
    b = qweight.contiguous().view(torch.uint8).reshape(rows8, out_dim, 4)
    b = b.permute(0, 2, 1).reshape(4 * rows8, out_dim)
    return torch.bitwise_xor(b, 0x88).view(torch.int8)


def permute_rows(packed: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Packed (IN/2, OUT) int8 with its logical rows taken in ``perm``'s order."""
    b = packed.view(torch.uint8)
    rows = torch.stack([b & 0xF, b >> 4], dim=1).reshape(2 * b.shape[0], b.shape[1])
    rows = rows.index_select(0, perm.to(device=rows.device, dtype=torch.long))
    return (rows[0::2] | (rows[1::2] << 4)).view(torch.int8)


def to_native_int4(sd, name: str, device="cpu", kind: str = "", index: int = 0,
                   count: int = 1) -> Optional[Dict[str, torch.Tensor]]:
    """Losslessly convert the GPTQ linear at ``name`` to the port's int4
    layout on ``device``: returns {'kernel_q4', 'scales4'[, 'zeros4'][,
    'perm4']}, bit-equal to ``chatts_tpu.models.gptq.to_native_int4``, or None
    when the port's kernels do not take the shape (group size not 128, IN or
    OUT not a multiple of 128, unbalanced groups).

    - symmetric (all zeros == 8, the ``sym=True`` export): W = s*(code-8),
      code-8 in [-8, 7] -- the kernel's signed-int4 view, no correction.
    - asymmetric zero-points: W = s*(code-z) = s*(code-8) + s*(8-z); the
      second term depends only on the group sum of the activations, so it is
      applied outside the kernel as a rank-G matmul with
      ``zeros4[g, o] = s[g, o] * (8 - z[g, o])`` (``qwen.Dense``).
    - desc_act (non-trivial ``g_idx``): rows are permuted so each group's
      inputs are contiguous (GPTQ groups are balanced by construction);
      ``perm4`` records the input permutation the activations follow at run
      time (one column gather per matmul).

    With ``kind`` "col" or "row" the result is shard ``index`` of ``count``
    of the whole layer's, to the bit, each field cut where
    ``parallel/sharding.py::shard_dim`` cuts it: "col" OUT/count output
    columns (``perm4`` whole), "row" IN/count input rows and their groups
    (``perm4`` this shard's part: the rows of the sorted groups, in the
    original input's numbering); a split that leaves partial groups raises.

    Only ``qweight`` goes to ``device`` before it is converted, and only the
    shard's rows or columns of it and of ``scales`` are read, except by an
    activation-order row shard, whose rows lie all over ``qweight``: it
    reads it whole.  The zeros and the group map are small and are read
    whole, on the host, for the export-wide decisions."""
    plan = _native_plan(sd, name)
    if plan is None:
        return None
    zeros, perm = plan

    def dim(field: str) -> Optional[int]:
        return sharding.shard_dim(kind, field) if kind else None

    def read(key: str, field: str, dev) -> torch.Tensor:
        d = dim(field)
        if d is None:
            return state_tensor(sd, key, dev)
        start, stop = sharding.split_range(sd_shape(sd, key)[d], index, count)
        if hasattr(sd, "get_slice"):
            return sd.get_slice(key, d, start, stop, dev)
        return _cut(state_tensor(sd, key, dev), d, index, count).contiguous()

    scales = read(name + ".scales", "scales4", "cpu").float().numpy()
    perm_t = None if perm is None else torch.from_numpy(perm).to(device)
    if perm_t is not None and dim("kernel_q4") == 0:  # the input rows are cut
        whole = permute_rows(native_codes(state_tensor(sd, name + ".qweight", device)), perm_t)
        packed = _cut(whole, dim("kernel_q4"), index, count).contiguous()
    else:
        packed = native_codes(read(name + ".qweight", "kernel_q4", device))
        if perm_t is not None:
            packed = permute_rows(packed, perm_t)
    out = {"kernel_q4": packed, "scales4": torch.from_numpy(scales).to(device)}
    if perm_t is not None:
        out["perm4"] = _cut(perm_t, dim("perm4"), index, count).contiguous()
    if zeros is not None:
        zeros = _cut(zeros, dim("zeros4"), index, count)
        out["zeros4"] = torch.from_numpy((scales * (8.0 - zeros)).astype(np.float32)).to(device)
    return out


def _cut(a, d: Optional[int], index: int, count: int):
    """Part ``index`` of ``count`` of array or tensor ``a`` along dim ``d``
    (``a`` itself for None)."""
    if d is None:
        return a
    start, stop = sharding.split_range(a.shape[d], index, count)
    return a[(slice(None),) * d + (slice(start, stop),)]


def _native_plan(sd, name: str):
    """(zero-points (groups, out) or None for a symmetric export, the
    desc_act input permutation or None) when the GPTQ linear at ``name``
    converts natively, else None: the export-wide decisions of
    ``to_native_int4``, from the small ``qzeros`` and ``g_idx`` and the
    headers."""
    zeros = unpack_int4(np.asarray(sd[name + ".qzeros"]), axis=1) + 1  # (groups, out)
    in_dim = 8 * sd_shape(sd, name + ".qweight")[0]
    groups, out_dim = sd_shape(sd, name + ".scales")
    if in_dim % groups != 0:
        return None
    group_size = in_dim // groups
    perm = None
    if name + ".g_idx" in sd:
        g_idx = np.asarray(sd[name + ".g_idx"])
        if not np.array_equal(g_idx, np.arange(in_dim) // group_size):
            counts = np.bincount(g_idx, minlength=groups)
            if not np.all(counts == group_size):
                return None
            perm = np.argsort(g_idx, kind="stable").astype(np.int32)
    if group_size != DEFAULT_GROUP or in_dim % 128 or out_dim % 128:
        return None
    return (None if np.all(zeros == 8) else zeros), perm


def load_gptq_kernel(sd, name: str) -> np.ndarray:
    """Dequantize the GPTQ linear at ``name`` to a dense (in, out) kernel."""
    g_idx = None
    if name + ".g_idx" in sd:
        g_idx = np.asarray(sd[name + ".g_idx"])
    return dequantize(
        np.asarray(sd[name + ".qweight"]),
        np.asarray(sd[name + ".qzeros"]),
        np.asarray(sd[name + ".scales"], np.float32),
        g_idx=g_idx,
    )
