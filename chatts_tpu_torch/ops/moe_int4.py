"""Routed experts in int4: the CUDA kernels ``csrc/moe_int4.cu`` and their
plain PyTorch version.

Each token is routed to K of the experts (``topk_idx`` (T, K), ``topk_w``
(T, K) f32, the router's choice); a layer holds the experts
[first, first + E) of them, each a SiLU MLP in B3's int4 layout (packed
(IN/2, OUT) int8 bytes, f32 scales a group of 128 input rows), stacked on
dim 0: ``gate_up`` (E, H/2, 2I) with the gate's I columns first, ``down``
(E, I/2, H).  The result (T, H) is, for each token, the sum over its K
choices in order of weight x expert(x) in f32, rounded to x's type once; a
choice of an expert the layer does not hold adds nothing (no exchange with
other holders is made here).

The kernels, four launches and no host sync, so a CUDA graph can hold them:
the token-expert pairs are counted and sorted by expert on the device
(``moe_int4_route_kernel``, which also adds the counts to a per-layer
counter), then one grouped GEMM launch over all the experts for gate/up with
SiLU x up in its epilogue, one for down, and a combine of each token's K
rows.  ``moe_int4.launches`` counts the calls that launched them.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from chatts_tpu_torch.kernels import build
from chatts_tpu_torch.ops.int4_matmul import int4_matmul_reference

GROUP = 128

_SIGNATURES = {
    "chatts_moe_int4": (
        ctypes.c_int,
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    ),
    "chatts_moe_int4_workspace_bytes": (ctypes.c_longlong, [ctypes.c_int] * 5),
}


def moe_int4_reference(x: torch.Tensor, topk_idx: torch.Tensor, topk_w: torch.Tensor,
                       gate_up_q4: torch.Tensor, gate_up_s4: torch.Tensor,
                       down_q4: torch.Tensor, down_s4: torch.Tensor, *, first: int = 0,
                       counts: Optional[torch.Tensor] = None,
                       matmul: Callable = int4_matmul_reference) -> torch.Tensor:
    """Plain version: each held expert's rows through ``matmul`` (each
    product rounded to x's type), SiLU(gate) x up in f32 rounded to x's type,
    down; each token's K rows times their weights summed in f32 in choice
    order, rounded once.  ``counts`` (E,) int32, when given, gains each held
    expert's routed rows."""
    t, k = topk_idx.shape
    e_held = gate_up_q4.shape[0]
    inter = down_q4.shape[1] * 2
    local = topk_idx.long() - first
    held = (local >= 0) & (local < e_held)
    if counts is not None:
        counts += torch.bincount(local[held], minlength=e_held).to(counts.dtype)
    y = torch.zeros((t, k, x.shape[1]), dtype=torch.float32, device=x.device)
    for e in range(e_held):
        rows, ks = torch.nonzero(local == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        h = matmul(x[rows], gate_up_q4[e], gate_up_s4[e])
        act = (F.silu(h[:, :inter].float()) * h[:, inter:].float()).to(x.dtype)
        y[rows, ks] = matmul(act, down_q4[e], down_s4[e]).float()
    out = torch.zeros((t, x.shape[1]), dtype=torch.float32, device=x.device)
    for j in range(k):
        out = out + y[:, j] * torch.where(held[:, j], topk_w[:, j].float(), 0.0)[:, None]
    return out.to(x.dtype)


def rows_per_tile(t: int, k: int, experts: int) -> int:
    """The grouped GEMMs' row tile for T tokens of K choices over the held
    experts, from the shapes alone: 16 rows while an expert's share is a
    few rows (decode: every weight byte is read once for them), up to 64
    where the shares are long (prefill)."""
    share = t * k / max(experts, 1)
    return 16 if share <= 24 else 32 if share <= 48 else 64


def _check(x, topk_idx, topk_w, gate_up_q4, gate_up_s4, down_q4, down_s4, counts) -> None:
    t, hid = x.shape
    e, half_h, two_i = gate_up_q4.shape
    inter = two_i // 2
    if x.dtype != torch.bfloat16:
        raise ValueError(f"moe_int4: the kernels take bf16 x, got {x.dtype}")
    if (half_h * 2 != hid or hid % GROUP or inter % GROUP or inter % 64
            or gate_up_s4.shape != (e, hid // GROUP, two_i)
            or down_q4.shape != (e, inter // 2, hid) or down_s4.shape != (e, inter // GROUP, hid)
            or hid % 128):
        raise ValueError(f"moe_int4: bad expert shapes gate_up {tuple(gate_up_q4.shape)} down "
                         f"{tuple(down_q4.shape)} for x {tuple(x.shape)}")
    if gate_up_q4.dtype != torch.int8 or down_q4.dtype != torch.int8 \
            or gate_up_s4.dtype != torch.float32 or down_s4.dtype != torch.float32:
        raise ValueError("moe_int4: packed weights int8, scales float32")
    if topk_idx.shape != topk_w.shape or topk_idx.shape[0] != t \
            or topk_idx.dtype != torch.int32 or topk_w.dtype != torch.float32:
        raise ValueError("moe_int4: topk_idx (T, K) int32 and topk_w (T, K) float32")
    if counts is not None and (counts.shape != (e,) or counts.dtype != torch.int32):
        raise ValueError("moe_int4: counts must be (E,) int32")
    for z in (x, topk_idx, topk_w, gate_up_q4, gate_up_s4, down_q4, down_s4):
        if not z.is_contiguous() or z.device != x.device:
            raise ValueError("moe_int4: inputs must be contiguous, on one device")


def moe_int4(x: torch.Tensor, topk_idx: torch.Tensor, topk_w: torch.Tensor,
             gate_up_q4: torch.Tensor, gate_up_s4: torch.Tensor, down_q4: torch.Tensor,
             down_s4: torch.Tensor, *, first: int = 0,
             counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The routed experts' sum (T, H) in x's type (see the module's
    docstring); ``counts`` (E,) int32 gains each held expert's routed rows."""
    build.refuse_gradients("moe_int4", x)
    if x.device.type == "cpu":
        return moe_int4_reference(x, topk_idx, topk_w, gate_up_q4, gate_up_s4, down_q4,
                                  down_s4, first=first, counts=counts)
    x = x.contiguous()
    topk_idx = topk_idx.to(torch.int32).contiguous()
    topk_w = topk_w.to(torch.float32).contiguous()
    _check(x, topk_idx, topk_w, gate_up_q4, gate_up_s4, down_q4, down_s4, counts)
    t, hid = x.shape
    k = topk_idx.shape[1]
    e, _, two_i = gate_up_q4.shape
    bm = rows_per_tile(t, k, e)
    lib = build.load("moe_int4", _SIGNATURES)
    ws = torch.empty((lib.chatts_moe_int4_workspace_bytes(t, k, e, two_i // 2, hid),),
                     dtype=torch.uint8, device=x.device)
    out = torch.empty_like(x)
    err = lib.chatts_moe_int4(
        x.data_ptr(), topk_idx.data_ptr(), topk_w.data_ptr(), gate_up_q4.data_ptr(),
        gate_up_s4.data_ptr(), down_q4.data_ptr(), down_s4.data_ptr(),
        0 if counts is None else counts.data_ptr(), ws.data_ptr(), out.data_ptr(),
        t, k, e, two_i // 2, hid, first, bm, build.stream_handle(x.device))
    moe_int4.launches += 1
    build.check_launch(err, "moe_int4")
    return out


moe_int4.launches = 0
