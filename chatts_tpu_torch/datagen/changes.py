"""Local-change injectors for synthetic time series.

The port's copy of ``chatts_tpu/datagen/changes.py``: the same numpy code, so a seed
gives the same bits in both packages.

Functional re-design of the reference's 19-class change hierarchy
(reference: chatts/ts_generator/local_changes.py:29-658) and its easing/spike
primitives (reference: chatts/ts_generator/change_utils.py:19-53).  Every
change is a plain function registered in :data:`CHANGE_REGISTRY`; all
randomness flows through an explicit ``numpy.random.Generator`` so generation
is fully deterministic under a seed (the reference mixes global ``random`` and
``np.random`` state).

Behavioral contract kept intact: the 19 change-type names, their min-length
and placement rules (non-overlap search, min interval max(seq/8, min_len, 20)),
amplitude draws (|N(0, var)|+base scaled by overall amplitude), shape
construction, the recorded ``position_start/position_end/amplitude`` fields,
and the ``detail`` narration strings with ``<|idx|>`` value placeholders that
``generate_time_series`` later substitutes with realized values.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np


class ChangePlacementError(Exception):
    """Raised when a change cannot be placed (too short / too crowded)."""


@dataclasses.dataclass
class ChangeRecord:
    type: str
    position_start: int
    position_end: int
    amplitude: float
    detail: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def easing_change(
    rng: np.random.Generator, length: int, amplitude: float,
    add_random_noise: bool = True,
) -> np.ndarray:
    """A 0->amplitude ramp with one of four easing shapes
    (reference: change_utils.py:19-36)."""
    x = np.arange(length) / max(length, 1)
    shape = rng.integers(0, 4)
    if shape == 0:
        cur = x ** 2
    elif shape == 1:
        cur = np.sin(x * np.pi / 2)
    elif shape == 2:
        cur = x.copy()
    else:
        cur = 1.0 - (1.0 - x) ** 2
    if add_random_noise and length > 3 and rng.random() > 0.8:
        cur = cur + rng.uniform(-1.0, 1.0, length) * rng.uniform(0.1, 0.3)
    return cur / (cur.max() - cur.min() + 1e-7) * amplitude


def spike_shape(
    rng: np.random.Generator, amplitude: float, max_length: Optional[int] = None
) -> np.ndarray:
    """1-3 point rise + optional 0-2 point peak + 1-3 point fall
    (reference: change_utils.py:38-53)."""
    if max_length is not None and max_length < 2:
        # Not enough room for a rise+fall; callers reject-and-resample
        # (reference defensive-generation pattern, SURVEY §4.4).
        raise ValueError("spike needs at least 2 points of room")
    while True:
        rise = rng.choice([1, 2, 3], p=[0.96, 0.03, 0.01])
        fall = rng.choice([1, 2, 3], p=[0.96, 0.03, 0.01])
        peak = rng.choice([0, 1, 2], p=[0.99, 0.005, 0.005])
        if max_length is None or rise + fall + peak <= max_length:
            break
    out = np.zeros(rise + peak + fall, dtype=np.float64)
    out[:rise] += easing_change(rng, rise, amplitude)
    out[rise:] += amplitude
    out[rise + peak:] += easing_change(rng, fall, -amplitude)
    return out


def _draw_amplitude(
    rng: np.random.Generator, overall_amplitude: float,
    base: float = 0.8, variance: float = 2.0,
) -> float:
    return (base + abs(rng.normal(0.0, variance))) * overall_amplitude


def _place(
    rng: np.random.Generator,
    seq_len: int,
    min_length: int,
    occupied: List[ChangeRecord],
) -> int:
    """Find a start position respecting non-overlap + min spacing
    (reference: local_changes.py:49-79)."""
    max_start = seq_len - min_length
    if max_start < 0:
        raise ChangePlacementError(
            f"sequence length {seq_len} shorter than change minimum {min_length}"
        )
    min_interval = max(seq_len / 8, min_length, 20)
    for _ in range(1000):
        start = int(rng.integers(0, max_start + 1))
        ok = True
        for rec in occupied:
            if rec.position_start <= start < rec.position_end:
                ok = False
                break
            if (
                abs(start + min_length - rec.position_start) < min_interval
                or abs(start - rec.position_end) < min_interval
            ):
                ok = False
                break
        if ok and start + min_length <= seq_len:
            return start
    raise ChangePlacementError("no non-overlapping position found in 1000 tries")


# ---------------------------------------------------------------------------
# Change implementations.  Each returns (y-delta applied in place, record).
# ---------------------------------------------------------------------------

ChangeFn = Callable[..., ChangeRecord]
CHANGE_REGISTRY: Dict[str, dict] = {}


def register(name: str, min_length: int):
    def deco(fn: ChangeFn):
        CHANGE_REGISTRY[name] = {"fn": fn, "min_length": min_length}
        return fn

    return deco


@register("shake", min_length=8)
def shake(rng, y, seq_len, overall_amplitude, start, amplitude):
    if amplitude is None:
        amplitude = _draw_amplitude(rng, overall_amplitude)
    remaining = seq_len - start - 1
    length = min(int(rng.integers(8, max(int(seq_len * 0.15), 16) + 1)), remaining)
    y[start : start + length] += rng.uniform(-1, 1, length) * amplitude / 2
    end = start + length
    detail = (
        f"shake with an amplitude of about {amplitude:.2f} occurred between "
        f"point {start} and point {end}"
    )
    return ChangeRecord("shake", start, end, amplitude, detail)


def _single_spike(rng, y, seq_len, overall_amplitude, start, amplitude, up: bool):
    if amplitude is None:
        amplitude = _draw_amplitude(rng, overall_amplitude, variance=6.0)
    remaining = seq_len - start - 1
    spike = spike_shape(rng, amplitude if up else -amplitude, remaining)
    n = min(len(spike), remaining)
    y[start : start + n] += spike[:n]
    top = start + int(np.argmax(np.abs(spike[:n])))
    end = start + n
    word, verb1, verb2 = (
        ("upward", "rising", "falling back")
        if up
        else ("downward", "falling", "rising back")
    )
    detail = (
        f"an {word} spike with an amplitude of {amplitude:.2f} occurred between "
        f"point {start} and point {end}, with the time series value rapidly "
        f"{verb1} from around <|{start}|> to around <|{top}|> and then quickly "
        f"{verb2} to around <|{end}|>"
    ) if up else (
        f"a {word} spike with an amplitude of {amplitude:.2f} occurred between "
        f"point {start} and point {end}, with the time series value rapidly "
        f"{verb1} from around <|{start}|> to around <|{top}|> and then quickly "
        f"{verb2} to around <|{end}|>"
    )
    name = "upward spike" if up else "downward spike"
    return ChangeRecord(name, start, end, amplitude, detail)


@register("upward spike", min_length=3)
def upward_spike(rng, y, seq_len, oa, start, amplitude):
    return _single_spike(rng, y, seq_len, oa, start, amplitude, up=True)


@register("downward spike", min_length=3)
def downward_spike(rng, y, seq_len, oa, start, amplitude):
    return _single_spike(rng, y, seq_len, oa, start, amplitude, up=False)


def _continuous_spikes(rng, y, seq_len, oa, start, amplitude, up: bool):
    if amplitude is None:
        amplitude = _draw_amplitude(rng, oa, variance=6.0)
    sign = 1 if up else -1
    remaining = seq_len - start - 1
    num = min(int(rng.integers(2, 6)), remaining // 3)
    peaks, tops, amps = [], [], []
    pos = start
    for _ in range(num):
        used = pos - start
        if remaining - used < 3:
            break
        peak_start = pos + int(rng.integers(0, min(3, remaining - used - 3) + 1))
        cur_amp = rng.uniform(amplitude * 0.6, amplitude * 1.5)
        amps.append(cur_amp)
        peaks.append(f"point {peak_start}")
        spike = spike_shape(rng, sign * cur_amp, remaining - (peak_start - start))
        n = min(len(spike), seq_len - peak_start)
        y[peak_start : peak_start + n] += spike[:n]
        pos = peak_start + n
        tops.append(peak_start + int(np.argmax(np.abs(spike[:n]))))
    end = pos
    realized_amp = float(np.mean(amps)) if amps else amplitude
    word = "upward" if up else "downward"
    action = "rising" if up else "falling"
    tops_str = "|> and <|".join(map(str, tops))
    detail = (
        f"at {' and '.join(peaks)}, there were {len(amps)} consecutive {word} "
        f"spikes with amplitudes ranging from {min(amps):.2f} to {max(amps):.2f}, "
        f"with the time series value repeatedly {action} sharply from around "
        f"<|{start}|> to around <|{tops_str}|>, and then quickly falling back "
        f"to around <|{end}|>"
    )
    name = f"continuous {word} spike"
    return ChangeRecord(name, start, end, realized_amp, detail)


@register("continuous upward spike", min_length=10)
def continuous_upward_spike(rng, y, seq_len, oa, start, amplitude):
    return _continuous_spikes(rng, y, seq_len, oa, start, amplitude, up=True)


@register("continuous downward spike", min_length=10)
def continuous_downward_spike(rng, y, seq_len, oa, start, amplitude):
    return _continuous_spikes(rng, y, seq_len, oa, start, amplitude, up=False)


def _convex(rng, y, seq_len, oa, start, amplitude, up: bool):
    if amplitude is None:
        amplitude = _draw_amplitude(rng, oa)
    sign = 1 if up else -1
    remaining = seq_len - start - 1
    start_len = min(int(rng.integers(1, 5)), remaining // 3)
    end_len = min(int(rng.integers(1, 5)), (remaining - start_len) // 2)
    body = min(
        int(rng.integers(max(int(seq_len * 0.03), 6), max(int(seq_len * 0.2), 16) + 1)),
        remaining - start_len - end_len,
    )
    body = max(1, body)
    y[start : start + start_len] += easing_change(rng, start_len, sign * amplitude)
    y[start + start_len : start + start_len + body] += sign * amplitude
    tail0 = start + start_len + body
    y[tail0 : tail0 + end_len] += easing_change(rng, end_len, -sign * amplitude) + sign * amplitude
    end = tail0 + end_len
    x = np.arange(seq_len)
    if rng.random() > 0.7:
        y[start + start_len : tail0] += np.sin(
            (0.8 + abs(rng.normal(0.0, 2.0))) * x
        )[start + start_len : tail0]
    if rng.random() > 0.7:
        y[start + start_len : tail0] += (
            rng.uniform(-1.0, 1.0, body) * rng.uniform(0.1, 0.5) * amplitude
        )
    word = "upward" if up else "downward"
    verbs = ("rises", "falls") if up else ("falls", "rises")
    detail = (
        f"starting from point {start}, the time series value {verbs[0]} from "
        f"around <|{start}|> to around <|{start + start_len}|>, forms a {word} "
        f"convex with an amplitude of about {amplitude:.2f}, and then "
        f"{verbs[1]} back to around <|{end}|>"
    )
    return ChangeRecord(f"{word} convex", start, end, amplitude, detail)


@register("upward convex", min_length=15)
def upward_convex(rng, y, seq_len, oa, start, amplitude):
    return _convex(rng, y, seq_len, oa, start, amplitude, up=True)


@register("downward convex", min_length=15)
def downward_convex(rng, y, seq_len, oa, start, amplitude):
    return _convex(rng, y, seq_len, oa, start, amplitude, up=False)


def _sudden(rng, y, seq_len, oa, start, amplitude, up: bool, drop_prompt: bool = True):
    if amplitude is None:
        amplitude = _draw_amplitude(rng, oa)
    sign = 1 if up else -1
    remaining = seq_len - start - 1
    shift_len = min(int(rng.integers(1, 11)), remaining)
    y[start : start + shift_len] += easing_change(rng, shift_len, sign * amplitude)
    y[start + shift_len :] += sign * amplitude
    end = start + shift_len
    action = "increase" if up else "decrease"
    movement = "rising" if up else "falling"
    detail = (
        f"a sudden {action} with an amplitude of {amplitude:.2f} occurred "
        f"between point {start} and point {end}, with the time series value "
        f"{movement} from around <|{max(start - 1, 0)}|> to around <|{end}|>"
    )
    # 50% chance of a partial recovery tail (reference: local_changes.py:303-313).
    if rng.random() < 0.5:
        rec_len = min(int(rng.integers(1, 11)), seq_len - start - shift_len)
        if rec_len > 0:
            rec_amp = rng.uniform(0, amplitude / 3)
            y[end : end + rec_len] += easing_change(rng, rec_len, -sign * rec_amp)
            y[end + rec_len :] -= sign * rec_amp
            if drop_prompt:
                rec_word = "drop" if up else "rise"
                rec_move = "falling" if up else "rising"
                detail += (
                    f", then a {rec_word} with an amplitude of {rec_amp:.2f} "
                    f"occurred between point {end} and point {end + rec_len}, "
                    f"with the time series value {rec_move} back to around "
                    f"<|{min(end + rec_len + 1, seq_len - 1)}|>"
                )
    name = "sudden increase" if up else "sudden decrease"
    return ChangeRecord(name, start, end, amplitude, detail)


@register("sudden increase", min_length=2)
def sudden_increase(rng, y, seq_len, oa, start, amplitude):
    return _sudden(rng, y, seq_len, oa, start, amplitude, up=True)


@register("sudden decrease", min_length=2)
def sudden_decrease(rng, y, seq_len, oa, start, amplitude):
    return _sudden(rng, y, seq_len, oa, start, amplitude, up=False)


def _two_phase(rng, y, seq_len, oa, start, amplitude, rapid_first: bool, up_first: bool):
    """Four combos of rapid/slow rise/decline (reference:
    local_changes.py:341-428)."""
    if amplitude is None:
        amplitude = _draw_amplitude(rng, oa)
    remaining = seq_len - start - 1
    short = lambda: int(rng.integers(1, 6))
    long = lambda: int(
        rng.integers(max(int(seq_len * 0.05), 8), max(int(seq_len * 0.15), 20) + 1)
    )
    first_len = min(short() if rapid_first else long(), remaining // 2)
    second_len = min(long() if rapid_first else short(), remaining - first_len)
    sign = 1 if up_first else -1
    y[start : start + first_len] += easing_change(rng, first_len, sign * amplitude)
    mid = start + first_len
    y[mid : mid + second_len] += easing_change(rng, second_len, -sign * amplitude) + sign * amplitude
    end = mid + second_len

    if rapid_first and up_first:
        name = "rapid rise followed by slow decline"
        detail = (
            f"a rapid rise with an amplitude of {amplitude:.2f} occurred between "
            f"point {start} and point {mid}, with the time series value rising "
            f"from around <|{max(start - 1, 0)}|> to around <|{mid}|>, followed "
            f"by a slow decline between point {mid} and point {end} back to "
            f"around <|{end}|>"
        )
    elif not rapid_first and up_first:
        name = "slow rise followed by rapid decline"
        detail = (
            f"starting from point {start}, the time series value slowly rises, "
            f"reaching a peak at point {mid}, followed by a rapid decline "
            f"between point {mid} and point {end} back to around <|{end}|>"
        )
    elif rapid_first and not up_first:
        name = "rapid decline followed by slow rise"
        detail = (
            f"a rapid decline with an amplitude of {amplitude:.2f} occurred "
            f"between point {start} and point {mid}, with the time series value "
            f"falling from around <|{max(start - 1, 0)}|> to around <|{mid}|>, "
            f"followed by a slow rise between point {mid} and point {end} back "
            f"to around <|{end}|>"
        )
    else:
        name = "slow decline followed by rapid rise"
        detail = (
            f"starting from point {start}, the time series value slowly "
            f"declines, reaching a low point at point {mid}, followed by a "
            f"rapid rise between point {mid} and point {end} back to around "
            f"<|{end}|>"
        )
    return ChangeRecord(name, start, end, amplitude, detail)


@register("rapid rise followed by slow decline", min_length=10)
def rapid_rise_slow_decline(rng, y, seq_len, oa, start, amplitude):
    return _two_phase(rng, y, seq_len, oa, start, amplitude, True, True)


@register("slow rise followed by rapid decline", min_length=10)
def slow_rise_rapid_decline(rng, y, seq_len, oa, start, amplitude):
    return _two_phase(rng, y, seq_len, oa, start, amplitude, False, True)


@register("rapid decline followed by slow rise", min_length=10)
def rapid_decline_slow_rise(rng, y, seq_len, oa, start, amplitude):
    return _two_phase(rng, y, seq_len, oa, start, amplitude, True, False)


@register("slow decline followed by rapid rise", min_length=10)
def slow_decline_rapid_rise(rng, y, seq_len, oa, start, amplitude):
    return _two_phase(rng, y, seq_len, oa, start, amplitude, False, False)


def _spike_then_drift(rng, y, seq_len, oa, start, amplitude, spike_up: bool, drift_up: bool):
    """Spike followed by a lasting level shift (reference:
    local_changes.py:438-551)."""
    if amplitude is None:
        amplitude = _draw_amplitude(rng, oa, variance=6.0)
    remaining = seq_len - start - 1
    drift_amp = rng.uniform(0.1, 0.7) * amplitude
    sign_spike = 1 if spike_up else -1
    sign_drift = 1 if drift_up else -1
    spike = spike_shape(rng, sign_spike * amplitude, remaining)
    peak_len = min(len(spike), remaining // 2)
    drift_len = min(
        int(rng.integers(2, max(int(seq_len * 0.05), 12) + 1)), remaining - peak_len
    )
    y[start : start + peak_len] += spike[:peak_len]
    top = start + int(np.argmax(np.abs(spike[:peak_len])))
    mid = start + peak_len
    y[mid : mid + drift_len] += easing_change(rng, drift_len, sign_drift * drift_amp)
    y[mid + drift_len :] += sign_drift * drift_amp
    end = mid + drift_len

    spike_word = "upward" if spike_up else "downward"
    spike_art = "an" if spike_up else "a"
    spike_move = (
        f"rapidly rising from around <|{max(start - 1, 0)}|> to around <|{top}|> "
        f"and quickly falling back"
        if spike_up
        else f"rapidly falling from around <|{start}|> to around <|{top}|> "
        f"and quickly rising back"
    )
    drift_word = "rise" if drift_up else "decline"
    detail = (
        f"{spike_art} {spike_word} spike with an amplitude of {amplitude:.2f} "
        f"occurred between point {start} and point {mid}, with the time series "
        f"value {spike_move}, followed by a further {drift_word} between point "
        f"{mid} and point {end} to around <|{end}|>"
    )
    if spike_up and not drift_up:
        name = "decrease after upward spike"
    elif not spike_up and drift_up:
        name = "increase after downward spike"
    elif spike_up and drift_up:
        name = "increase after upward spike"
    else:
        name = "decrease after downward spike"
    return ChangeRecord(name, start, end, amplitude, detail)


@register("decrease after upward spike", min_length=8)
def decrease_after_upward_spike(rng, y, seq_len, oa, start, amplitude):
    return _spike_then_drift(rng, y, seq_len, oa, start, amplitude, True, False)


@register("increase after downward spike", min_length=8)
def increase_after_downward_spike(rng, y, seq_len, oa, start, amplitude):
    return _spike_then_drift(rng, y, seq_len, oa, start, amplitude, False, True)


@register("increase after upward spike", min_length=8)
def increase_after_upward_spike(rng, y, seq_len, oa, start, amplitude):
    return _spike_then_drift(rng, y, seq_len, oa, start, amplitude, True, True)


@register("decrease after downward spike", min_length=8)
def decrease_after_downward_spike(rng, y, seq_len, oa, start, amplitude):
    return _spike_then_drift(rng, y, seq_len, oa, start, amplitude, False, False)


def _wide_spike(rng, y, seq_len, oa, start, amplitude, up: bool):
    if amplitude is None:
        amplitude = _draw_amplitude(rng, oa, variance=6.0)
    sign = 1 if up else -1
    remaining = seq_len - start - 1
    slope = lambda: int(
        rng.integers(max(int(seq_len * 0.02), 4), max(int(seq_len * 0.08), 8) + 1)
    )
    first_len = min(slope(), remaining // 3)
    peak_len = min(int(rng.integers(1, 4)), (remaining - first_len) // 2)
    second_len = min(slope(), remaining - first_len - peak_len)
    y[start : start + first_len] += easing_change(rng, first_len, sign * amplitude)
    y[start + first_len : start + first_len + peak_len] += sign * amplitude
    t0 = start + first_len + peak_len
    y[t0 : t0 + second_len] += easing_change(rng, second_len, -sign * amplitude) + sign * amplitude
    end = t0 + second_len
    if up:
        detail = (
            f"a slow rise from around <|{start}|> to around <|{start + first_len}|> "
            f"occurred between point {start} and point {start + first_len}, "
            f"forming a short peak with an amplitude of {amplitude:.2f}, "
            f"followed by a slow decline between point {t0} and point {end} "
            f"back to around <|{end}|>"
        )
        name = "wide upward spike"
    else:
        detail = (
            f"a slow decline from around <|{start}|> to around <|{start + first_len}|> "
            f"occurred between point {start} and point {start + first_len}, "
            f"forming a short trough with an amplitude of {amplitude:.2f}, "
            f"followed by a slow rise between point {t0} and point {end} "
            f"back to around <|{end}|>"
        )
        name = "wide downward spike"
    return ChangeRecord(name, start, end, amplitude, detail)


@register("wide upward spike", min_length=16)
def wide_upward_spike(rng, y, seq_len, oa, start, amplitude):
    return _wide_spike(rng, y, seq_len, oa, start, amplitude, up=True)


@register("wide downward spike", min_length=16)
def wide_downward_spike(rng, y, seq_len, oa, start, amplitude):
    return _wide_spike(rng, y, seq_len, oa, start, amplitude, up=False)


def supported_change_types() -> List[str]:
    return list(CHANGE_REGISTRY.keys())


def apply_local_changes(
    rng: np.random.Generator,
    local_specs: List[dict],
    overall_amplitude: float,
    seq_len: int,
    verbose: bool = False,
) -> tuple:
    """Apply requested local changes to a zero baseline.

    Returns (y delta, sorted list of realized change dicts).  Placement
    failures reject the individual change, mirroring the reference's
    skip-and-continue policy (reference: local_changes.py:661-713) with the
    exceeds-length invariant enforced.
    """
    y = np.zeros(seq_len)
    placed: List[ChangeRecord] = []
    for spec in local_specs:
        ctype = spec["type"]
        entry = CHANGE_REGISTRY.get(ctype)
        if entry is None:
            raise ValueError(f"Unknown change type: {ctype}")
        try:
            start = spec.get("position_start")
            if start is None:
                start = _place(rng, seq_len, entry["min_length"], placed)
            rec = entry["fn"](
                rng, y, seq_len, overall_amplitude, start, spec.get("amplitude")
            )
            if rec.position_end >= seq_len:
                raise ChangePlacementError(
                    f"change end {rec.position_end} >= seq_len {seq_len}"
                )
            placed.append(rec)
        except ChangePlacementError as e:
            if verbose:
                print(f"Warning (seq_len={seq_len}): {e}. Skipping this change.")
            continue
    placed.sort(key=lambda r: r.position_start)
    return y, [r.to_dict() for r in placed]
