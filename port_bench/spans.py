"""The reductions behind the per-layer metrics that read the engine's span
record: the host phases and device stamps that each round-log entry carries
(``chatts_tpu_torch/serve/scheduler.py``, ``ServeEngine._log_round``).  Each
reads the rounds of the measured part of the window (``RunRecord.rounds``,
over ``RunRecord.span``), and returns None, never 0, where no round carries
the field: off the card for the device stamps, and on a program whose
entries lack them."""
from __future__ import annotations

from typing import Optional


def _span_s(run) -> float:
    return run.span[1] - run.span[0]


def _carrying(run, field: str) -> list:
    return [r for r in run.rounds if r.get(field) is not None]


def share_pct(run, field: str) -> Optional[float]:
    """The seconds an entry's ``field`` gives (a loop phase's host seconds,
    or ``embed_dev_s``, device seconds), summed over the rounds, over the
    window's seconds."""
    rounds = _carrying(run, field)
    if not rounds or _span_s(run) <= 0:
        return None
    return 100.0 * sum(r[field] for r in rounds) / _span_s(run)


def device_gap_pct(run) -> Optional[float]:
    """The device's idle time between rounds over the window's seconds: for
    consecutive rounds ordered by ``dev_start``, the time from one's
    ``dev_end`` to the next one's ``dev_start`` less the device seconds of
    the work launched in between (``pre_dev_s``)."""
    rounds = sorted(_carrying(run, "dev_start"), key=lambda r: r["dev_start"])
    if len(rounds) < 2 or _span_s(run) <= 0:
        return None
    gap = sum(max(0.0, b["dev_start"] - a["dev_end"] - b["pre_dev_s"])
              for a, b in zip(rounds, rounds[1:]))
    return 100.0 * gap / _span_s(run)


def decode_step_device_ms(run) -> Optional[float]:
    """A decode round's device seconds (``dev_end - dev_start``) over its
    ``decode_chunk`` steps."""
    rounds = [r for r in _carrying(run, "dev_start") if r["kind"] == "decode"]
    if not rounds:
        return None
    return 1e3 * sum(r["dev_end"] - r["dev_start"] for r in rounds) / (
        len(rounds) * run.engine["decode_chunk"])
