"""The reductions behind the per-layer metrics.  Each metric's file in
``metrics/`` names one of these; each returns None where the run holds
nothing to read (no round of the kind, no trace, no launch of the kernel),
never 0 for a share of a roofline or a peak."""
from __future__ import annotations

import bisect
from typing import Optional

from port_bench import flops

ADMISSION_KINDS = ("mono", "block_pre", "block", "mixed")


def _span_s(run) -> float:
    return run.span[1] - run.span[0]


def admit_host_pct(run) -> Optional[float]:
    """Host time staging admissions after a round, while the device waits
    for the next: the sum of the rounds' ``admit_s`` over the window."""
    if not run.rounds or _span_s(run) <= 0:
        return None
    return 100.0 * sum(r["admit_s"] for r in run.rounds) / _span_s(run)


def decode_stall_pct(run) -> Optional[float]:
    """Round seconds in which live slots advance no token (block prefills
    and monolithic admissions run with slots live) over the window."""
    if not run.rounds or _span_s(run) <= 0:
        return None
    stalled = sum(r["round_s"] for r in run.rounds
                  if r["kind"] in ("block_pre", "mono") and r["live"] > 0)
    return 100.0 * stalled / _span_s(run)


def _decode_rounds(run):
    return [r for r in run.rounds if r["kind"] == "decode"]


def decode_occupancy_pct(run) -> Optional[float]:
    """Live slots over the slots, in the decode rounds."""
    rounds = _decode_rounds(run)
    if not rounds:
        return None
    return 100.0 * sum(r["live"] for r in rounds) / (
        len(rounds) * run.engine["max_batch_size"])


def decode_step_ms(run) -> Optional[float]:
    """A decode round's host seconds over its ``decode_chunk`` steps."""
    rounds = _decode_rounds(run)
    if not rounds:
        return None
    return 1e3 * sum(r["round_s"] for r in rounds) / (len(rounds) * run.engine["decode_chunk"])


def _round_flops(run):
    """(round, FLOPs of the tokens delivered in it) for the window's rounds:
    each delivery of tokens belongs to the round that ended next."""
    ends = [r["t"] for r in run.rounds]
    out = [0.0] * len(ends)
    if not ends:
        return []
    lo = run.span[0]
    for rec in run.records:
        prompt = rec.req.prompt_tokens if rec.req is not None else 0
        for t, f in run.family.request_flops(run.cfg, prompt, rec.puts):
            if not (lo < t <= ends[-1]):
                continue
            i = bisect.bisect_left(ends, t)
            out[i] += f
    return list(zip(run.rounds, out))


def mfu_pct(run, kinds=None) -> Optional[float]:
    """Model FLOPs of the tokens the rounds (of ``kinds``, all when None)
    delivered (the family's ``request_flops``), over their host seconds at
    the bf16 peak."""
    pairs = [(r, f) for r, f in _round_flops(run) if kinds is None or r["kind"] in kinds]
    seconds = sum(r["round_s"] for r, _ in pairs)
    work = sum(f for _, f in pairs)
    if seconds <= 0 or work <= 0:
        return None
    return 100.0 * work / (seconds * flops.PEAK_BF16_S)


def roofline_pct(run, kernel: str) -> Optional[float]:
    """The recorded launches' bounds over the device time of the kernels of
    ``kernel``, a key of the family's ``KERNELS``, in the traced sub-window;
    None where a launch's bound was unknown."""
    tr = run.trace
    if tr is None or f"{kernel}_device_s" not in tr:
        return None
    device, bound = tr[f"{kernel}_device_s"], tr[f"{kernel}_bound_s"]
    if device <= 0 or bound <= 0 or tr[f"{kernel}_unknown"]:
        return None
    return 100.0 * bound / device


def device_idle_pct(run) -> Optional[float]:
    tr = run.trace
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
