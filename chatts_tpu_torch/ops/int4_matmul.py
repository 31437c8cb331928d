"""int4 matmuls: the CUDA kernels ``csrc/int4_matmul.cu`` (weight-only) and
``csrc/int4_matmul_a8.cu`` (int8 activations), their plain PyTorch versions,
and the pack/unpack helpers.

Replaces ``chatts_tpu/ops/int4_matmul.py::int4_matmul`` and
``::int4_matmul_a8``.  The packed layout is the JAX package's, unchanged:

  logical W (IN, OUT)  ->  packed (IN//2, OUT) int8, where
      packed[i, j] = (W[2i, j] & 0xF) | (W[2i+1, j] << 4)
  scales (IN//G, OUT) float32, group g covering logical rows [g*G, (g+1)*G),
  G = 128.

``int4_matmul`` and ``int4_matmul_a8`` run the plain version for CPU tensors
and launch their kernel for CUDA tensors (G = 128, IN and OUT multiples of
128; bf16 x, or int8 x_q with a bf16 result); a CUDA call the kernel does not
take raises.  Each wrapper's ``launches`` counts the calls that launched its
kernel.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from chatts_tpu_torch.kernels import build
from chatts_tpu_torch.parallel.mesh import all_reduce_tp

DEFAULT_GROUP = 128

_SIGNATURES = {
    "chatts_int4_matmul": (
        ctypes.c_int,
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    ),
    "chatts_int4_matmul_workspace_bytes": (
        ctypes.c_longlong, [ctypes.c_int] * 4,
    ),
}

# The paths of ``csrc/int4_matmul.cu``: the mma.sync kernel in its
# streaming configuration (all rows up to 64 in one block row, 64-row tiles
# above) and the wgmma GEMM configuration (128 x 128 tiles of y^T, the
# weights as register operand A).
STREAM, GEMM = 1, 2
PATHS = {"stream": STREAM, "gemm": GEMM}

# The band.  Before the GEMM moved to wgmma, both paths lay within 4% of
# each other from R = 640 up at the ChatTS-14B projections (``chip_smoke.py``
# phase 2, H100 80GB HBM3, 700 W), streaming the faster at 640.  The wgmma
# GEMM takes the 8B layer's four projections at R = 4,096 in 3.58 ms against
# streaming's 7.46; ``chip_smoke.py::phase_int4_band`` times both at R = 512,
# 640, 641, 1,024, 2,048, 4,096 and 5,120 on the 14B, Qwen3-8B and
# Moonlight dense projections and prints where the GEMM becomes the faster.
# The band stays at 640 until that run puts the crossover below it at all
# three.
STREAM_MAX_ROWS = 640

_SIGNATURES_A8 = {
    "chatts_int4_matmul_a8": (
        ctypes.c_int,
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    ),
}

# ``csrc/int4_matmul_a8.cu`` runs one or two consumer warpgroups a block, 128
# output columns each, over a tile of 64 rows.  With one row tile (R <= 64)
# the grid is OUT / (128 warpgroups) blocks, so the narrow block doubles the
# blocks that stream the weights; above, the wide block reads each x_q tile
# once for 256 columns.
A8_NARROW_MAX_ROWS = 64
A8_WARPGROUPS = (1, 2)


def pack_int4(
    w: torch.Tensor, group_size: int = DEFAULT_GROUP
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize W (IN, OUT) -> (packed int8 (IN//2, OUT), scales f32 (IN//G, OUT)).
    Symmetric, clipped to [-7, 7], round half to even."""
    in_dim, out_dim = w.shape
    g = group_size
    if in_dim % g != 0:
        raise ValueError(f"IN {in_dim} not a multiple of group_size {g}")
    w3 = w.float().reshape(in_dim // g, g, out_dim)
    amax = w3.abs().amax(dim=1)
    # A tensor divisor, so the card divides too (a Python scalar divisor is
    # a reciprocal multiply there).
    scales = torch.clamp(amax / torch.full_like(amax, 7.0), min=1e-8)
    q = torch.clamp(torch.round(w3 / scales[:, None, :]), -7, 7)
    return pack_from_int4_values(q.to(torch.int8).reshape(in_dim, out_dim), scales)


def pack_from_int4_values(
    q: torch.Tensor, scales: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed layout from signed int4 values ``q`` (IN, OUT) in [-8, 7]: byte
    row i holds logical row 2i in its low nibble and 2i+1 in its high one."""
    lo = q[0::2].to(torch.int32) & 0xF
    hi = q[1::2].to(torch.int32) & 0xF
    packed = (lo | (hi << 4)).to(torch.int8)  # 128..255 wrap to negative int8
    return packed.contiguous(), scales.float()


def unpack_values(packed: torch.Tensor) -> torch.Tensor:
    """packed (IN//2, OUT) int8 -> logical values (IN, OUT) int32."""
    p32 = packed.to(torch.int32)
    lo = ((p32 & 0xF) ^ 8) - 8  # sign-extend the low nibble
    hi = p32 >> 4  # arithmetic shift keeps the high nibble's sign
    half, out = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * half, out)


def dequantize(
    packed: torch.Tensor, scales: torch.Tensor, dtype=torch.float32
) -> torch.Tensor:
    """W (IN, OUT) in ``dtype``: values times their group's scale, in f32."""
    q = unpack_values(packed)
    in_dim, out_dim = q.shape
    ng = scales.shape[0]
    w = q.float().reshape(ng, in_dim // ng, out_dim) * scales[:, None, :]
    return w.reshape(in_dim, out_dim).to(dtype)


def int4_matmul_reference(
    x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor
) -> torch.Tensor:
    """Plain version: dequantize to x's type, then one matmul (f32
    accumulation, result in x's type), as the JAX package does off the TPU.
    The wrapper runs it for CPU tensors."""
    return torch.matmul(x, dequantize(packed, scales, x.dtype))


def _grouped_f32(xf: torch.Tensor, packed: torch.Tensor,
                 scales: torch.Tensor) -> torch.Tensor:
    """sum over groups g of (xf[:, g] @ q[g]) * s_g, in f32, in group order:
    each group's product, times its scales, added to an f32 accumulator (the
    multiply and the add rounded apart).  One group at a time, so no
    (R, groups, OUT) intermediate is made."""
    g = xf.shape[1] // scales.shape[0]
    acc = torch.zeros((xf.shape[0], packed.shape[1]), dtype=torch.float32,
                      device=xf.device)
    for i in range(scales.shape[0]):
        w = unpack_values(packed[i * g // 2:(i + 1) * g // 2]).float()
        acc += torch.matmul(xf[:, i * g:(i + 1) * g], w) * scales[i]
    return acc


def int4_matmul_grouped_reference(
    x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor
) -> torch.Tensor:
    """Plain version of the kernel's own arithmetic, in the TPU kernel's
    order (``chatts_tpu/ops/int4_matmul.py::_kernel``): per 128-row group the
    f32 product of x and the integer values (every product exact), times the
    group's scales, added to an f32 accumulator; one rounding to x's type."""
    return _grouped_f32(x.float(), packed, scales).to(x.dtype)


def _check(x, packed, scales, what: str = "int4_matmul",
           x_dtype=torch.bfloat16) -> None:
    build.refuse_gradients(what, x, scales)
    if x.dim() != 2 or packed.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"{what}: x, packed and scales must be 2-D")
    r, in_dim = x.shape
    out_dim = packed.shape[1]
    if any(t.device != x.device for t in (packed, scales)):
        raise ValueError(f"{what}: all inputs must be on one device")
    if x.dtype != x_dtype:
        raise ValueError(f"{what}: the kernel takes {x_dtype} x, got {x.dtype}")
    if packed.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(f"{what}: packed must be int8 and scales float32")
    if in_dim % DEFAULT_GROUP or out_dim % 128:
        raise ValueError(f"{what}: IN {in_dim} and OUT {out_dim} must be "
                         "multiples of 128")
    if packed.shape != (in_dim // 2, out_dim) or scales.shape != (
            in_dim // DEFAULT_GROUP, out_dim):
        raise ValueError(f"{what}: the kernel takes group {DEFAULT_GROUP}; got x "
                         f"{tuple(x.shape)} packed {tuple(packed.shape)} scales "
                         f"{tuple(scales.shape)}")
    for t in (x, packed, scales):
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: inputs must be 16-byte aligned")
    if r < 1:
        raise ValueError(f"{what}: x has no rows")


def int4_path(r: int) -> int:
    """The kernel's path for R rows: streaming up to STREAM_MAX_ROWS, the
    GEMM above."""
    return STREAM if r <= STREAM_MAX_ROWS else GEMM


def int4_matmul_on_path(
    x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, path: int
) -> torch.Tensor:
    """Launch the kernel on ``path`` for CUDA tensors (``int4_matmul`` picks
    the path by R; this entry lets the card's tests and ``chip_smoke.py``
    hold every path against the plain versions)."""
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: no kernel for device {x.device}")
    _check(x, packed, scales)
    r, in_dim = x.shape
    if path not in PATHS.values():
        raise ValueError(f"int4_matmul: no path {path}")
    out_dim = packed.shape[1]
    lib = build.load("int4_matmul", _SIGNATURES)
    y = torch.empty((r, out_dim), dtype=x.dtype, device=x.device)
    ws_bytes = lib.chatts_int4_matmul_workspace_bytes(r, in_dim, out_dim, path)
    ws = torch.empty(ws_bytes // 4, dtype=torch.float32, device=x.device) if ws_bytes else None
    err = lib.chatts_int4_matmul(
        x.data_ptr(), packed.data_ptr(), scales.data_ptr(), y.data_ptr(),
        None if ws is None else ws.data_ptr(), r, in_dim, out_dim, path,
        build.stream_handle(x.device),
    )
    int4_matmul.launches += 1
    build.check_launch(err, "int4_matmul")
    return y


def int4_matmul(
    x: torch.Tensor,  # (R, IN)
    packed: torch.Tensor,  # (IN//2, OUT) int8
    scales: torch.Tensor,  # (IN//G, OUT) float32
) -> torch.Tensor:
    """y = x @ dequantize(packed, scales) -> (R, OUT) in x's type."""
    build.refuse_gradients("int4_matmul", x, scales)
    if x.device.type == "cpu":
        return int4_matmul_reference(x, packed, scales)
    return int4_matmul_on_path(x, packed, scales, int4_path(x.shape[0]))


int4_matmul.launches = 0


def int4_matmul_a8_reference(
    x_q: torch.Tensor, x_scale: torch.Tensor, packed: torch.Tensor,
    scales: torch.Tensor, out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Plain version, in the JAX kernel's order: per 128-row group the f32
    product of the integer values (exact: a group's sum is at most
    128 * 127 * 8 < 2**24), times the group's scales, added to an f32
    accumulator; then the row scales, and one rounding to ``out_dtype``."""
    acc = _grouped_f32(x_q.float(), packed, scales)
    return (acc * x_scale.float()[:, None]).to(out_dtype)


def a8_warpgroups(r: int) -> int:
    """Consumer warpgroups a block of the a8 kernel for R rows: one (128
    output columns a block) while the rows fit one 64-row tile, two above."""
    return 1 if r <= A8_NARROW_MAX_ROWS else 2


def int4_matmul_a8_on_width(
    x_q: torch.Tensor, x_scale: torch.Tensor, packed: torch.Tensor,
    scales: torch.Tensor, warpgroups: int, out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Launch the a8 kernel with ``warpgroups`` consumer warpgroups a block
    for CUDA tensors (``int4_matmul_a8`` picks by R; this entry lets the
    card's tests and ``chip_smoke.py`` hold both widths at any R)."""
    if x_q.device.type != "cuda":
        raise ValueError(f"int4_matmul_a8: no kernel for device {x_q.device}")
    _check(x_q, packed, scales, "int4_matmul_a8", torch.int8)
    r, in_dim = x_q.shape
    if (x_scale.shape != (r,) or x_scale.dtype != torch.float32
            or x_scale.device != x_q.device or not x_scale.is_contiguous()):
        raise ValueError(f"int4_matmul_a8: x_scale must be contiguous float32 ({r},) "
                         f"on {x_q.device}, got {x_scale.dtype} {tuple(x_scale.shape)}")
    if out_dtype != torch.bfloat16:
        raise ValueError(f"int4_matmul_a8: the kernel gives bf16, not {out_dtype}")
    if warpgroups not in A8_WARPGROUPS:
        raise ValueError(f"int4_matmul_a8: no block of {warpgroups} warpgroups")
    out_dim = packed.shape[1]
    lib = build.load("int4_matmul_a8", _SIGNATURES_A8)
    y = torch.empty((r, out_dim), dtype=torch.bfloat16, device=x_q.device)
    err = lib.chatts_int4_matmul_a8(
        x_q.data_ptr(), x_scale.data_ptr(), packed.data_ptr(), scales.data_ptr(),
        y.data_ptr(), r, in_dim, out_dim, warpgroups, build.stream_handle(x_q.device),
    )
    int4_matmul_a8.launches += 1
    build.check_launch(err, "int4_matmul_a8")
    return y


def int4_matmul_a8(
    x_q: torch.Tensor,  # (R, IN) int8, quantized per row
    x_scale: torch.Tensor,  # (R,) float32
    packed: torch.Tensor,  # (IN//2, OUT) int8
    scales: torch.Tensor,  # (IN//G, OUT) float32
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """y = diag(x_scale) @ (x_q @ dequantize(packed, scales)) -> (R, OUT) in
    ``out_dtype``; the kernel gives bf16."""
    build.refuse_gradients("int4_matmul_a8", x_scale, scales)
    if x_q.device.type == "cpu":
        return int4_matmul_a8_reference(x_q, x_scale, packed, scales, out_dtype)
    return int4_matmul_a8_on_width(x_q, x_scale, packed, scales,
                                   a8_warpgroups(x_q.shape[0]), out_dtype)


int4_matmul_a8.launches = 0


# ---------------------------------------------------------------------------
# Tensor parallelism: the port of ``int4_matmul_tp``.  JAX's shard_map gives
# each device its Megatron shard of the weights; here each rank holds its
# shard already (``parallel/sharding.py``).  Column-parallel (q, k, v, gate,
# up, the head: OUT over tp, x whole) is B3 on the rank's columns;
# row-parallel (o, down: IN over tp, x split with it) is B3 on the rank's
# input groups, then a sum over tp in x's type, as JAX's psum sums the
# kernel's x-typed output (``chatts_tpu/ops/int4_matmul.py:396-398``).
# ---------------------------------------------------------------------------

def supported_tp(mesh, in_dim: int, out_dim: int, group: int, kind: str) -> bool:
    """Whether the per-rank shapes of a (in_dim, out_dim) projection of
    ``kind`` ("col" or "row") still tile: JAX's rule (tp divides OUT, or IN
    and its groups), and the port's own, B3's (group 128, the rank's IN and
    OUT multiples of 128)."""
    tp = mesh.shape.get("tp", 1)
    if group != DEFAULT_GROUP or in_dim % group:
        return False
    if kind == "col":
        return out_dim % tp == 0 and (out_dim // tp) % 128 == 0 and in_dim % 128 == 0
    if kind == "row":
        ng = in_dim // group
        return (in_dim % tp == 0 and ng % tp == 0 and (in_dim // tp) % 128 == 0
                and out_dim % 128 == 0)
    return False


def int4_matmul_tp(
    x: torch.Tensor,  # (R, IN) whole ("col") or (R, IN/tp) this rank's part ("row")
    packed: torch.Tensor,  # this rank's shard: (IN//2, OUT/tp) or (IN/tp//2, OUT)
    scales: torch.Tensor,  # (IN//G, OUT/tp) or (IN/tp//G, OUT)
    *,
    mesh,
    kind: str,  # "col" | "row"
) -> torch.Tensor:
    """This rank's (R, OUT/tp) columns ("col"), or the whole (R, OUT) summed
    over the tp group ("row"), in x's type."""
    if kind not in ("col", "row"):
        raise ValueError(f"int4_matmul_tp: kind is 'col' or 'row', not {kind!r}")
    y = int4_matmul(x, packed, scales)
    return all_reduce_tp(mesh, y) if kind == "row" else y
