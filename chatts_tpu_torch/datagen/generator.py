"""Synthetic time-series generator: attribute pools -> series + exact labels.

The port's copy of ``chatts_tpu/datagen/generator.py``: the same numpy code, so a seed
gives the same bits in both packages.

Behavioral re-implementation of the reference synthesis engine
(reference: chatts/ts_generator/generate.py:38-682): sample overall
attributes (seasonal/trend/frequency/noise) and 0-3 local changes from
weighted pools, compose seasonal wave + local changes + trend + noise, and
back-fill the attribute pool with realized positions/amplitudes/statistics so
the textual ground truth is exact.  ``<|idx|>`` placeholders in local-change
narration are substituted with realized values before noise is added, exactly
as the reference does (generate.py:524-533).

Differences by design: all randomness flows through one
``numpy.random.Generator`` (seed-deterministic; the reference mixes global
``random`` and ``np.random``), config is an explicit dataclass rather than
import-time YAML reads, and the controlled-attribute path honors a provided
seasonal period instead of silently re-drawing it (the reference re-draws due
to a key-membership quirk at generate.py:487).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from chatts_tpu_torch.datagen import changes as changes_lib
from chatts_tpu_torch.datagen import trends as trends_lib
from chatts_tpu_torch.datagen.config import DEFAULT, DatagenConfig

# Weighted attribute pools (reference: generate.py:38-82).
ALL_ATTRIBUTE_SET = {
    "overall_attribute": {
        "seasonal": {
            "no periodic fluctuation": 0.7,
            "sin periodic fluctuation": 0.25,
            "square periodic fluctuation": 0.02,
            "triangle periodic fluctuation": 0.03,
        },
        "trend": {
            "decrease": 0.3,
            "increase": 0.3,
            "keep steady": 0.3,
            "multiple": 0.1,
        },
        "frequency": {"high frequency": 0.5, "low frequency": 0.5},
        "noise": {"noisy": 0.2, "almost no noise": 0.8},
    },
    "change": {
        "shake": 2,
        "upward spike": 12,
        "downward spike": 10,
        "continuous upward spike": 3,
        "continuous downward spike": 3,
        "upward convex": 2,
        "downward convex": 2,
        "sudden increase": 10,
        "sudden decrease": 10,
        "rapid rise followed by slow decline": 2,
        "slow rise followed by rapid decline": 2,
        "rapid decline followed by slow rise": 2,
        "slow decline followed by rapid rise": 2,
        "decrease after upward spike": 1,
        "increase after downward spike": 1,
        "increase after upward spike": 1,
        "decrease after downward spike": 1,
        "wide upward spike": 2,
        "wide downward spike": 2,
    },
}

# Change types that need room: dropped for short multi-trend series
# (reference: generate.py:111-124).
_LONG_CHANGES = (
    "upward convex",
    "downward convex",
    "rapid rise followed by slow decline",
    "slow rise followed by rapid decline",
    "rapid decline followed by slow rise",
    "slow decline followed by rapid rise",
    "decrease after upward spike",
    "increase after downward spike",
    "increase after upward spike",
    "decrease after downward spike",
    "wide upward spike",
    "wide downward spike",
)
_VERY_SHORT_DROPS = ("shake", "sudden increase", "sudden decrease")


def _weighted_choice(rng: np.random.Generator, weights: Dict[str, float]) -> str:
    keys = list(weights)
    p = np.asarray([weights[k] for k in keys], dtype=float)
    return str(rng.choice(keys, p=p / p.sum()))


def _weighted_choices(
    rng: np.random.Generator, weights: Dict[str, float], size: int
) -> List[str]:
    keys = list(weights)
    p = np.asarray([weights[k] for k in keys], dtype=float)
    return [str(x) for x in rng.choice(keys, size=size, p=p / p.sum())]


class TimeSeriesGenerator:
    """Seedable synthesis engine."""

    def __init__(
        self,
        config: DatagenConfig = DEFAULT,
        seed: Optional[int] = None,
        rng: Optional[np.random.Generator] = None,
    ):
        self.config = config
        self.rng = rng if rng is not None else np.random.default_rng(seed)

    # ------------------------------------------------------------------
    # Attribute sampling
    # ------------------------------------------------------------------

    def generate_random_attributes(
        self,
        overall_attribute: Optional[dict] = None,
        change_attribute: Optional[dict] = None,
        change_positions: Optional[Sequence[Tuple[Optional[int], Optional[float]]]] = None,
        seq_len: int = 512,
    ) -> dict:
        """Sample an attribute pool with the reference's short-sequence
        degradations (reference: generate.py:84-157)."""
        rng = self.rng
        overall = overall_attribute or ALL_ATTRIBUTE_SET["overall_attribute"]
        change_attr = dict(change_attribute or ALL_ATTRIBUTE_SET["change"])
        if change_positions is None:
            change_positions = [(None, None)] * int(rng.integers(0, 4))
        change_positions = list(change_positions)

        pool: dict = {}
        if seq_len >= 24:
            pool["seasonal"] = {"type": _weighted_choice(rng, overall["seasonal"])}
        else:
            pool["seasonal"] = {"type": "no periodic fluctuation"}

        trend_cands = dict(overall["trend"])
        if not self.config.enable_multiple_trend:
            trend_cands.pop("multiple", None)
        trend_type = _weighted_choice(rng, trend_cands)
        pool["trend"] = {"type": trend_type}

        if seq_len <= 64 and trend_type == "multiple":
            for k in _LONG_CHANGES:
                change_attr.pop(k, None)
        if seq_len <= 8:
            for k in _VERY_SHORT_DROPS:
                change_attr.pop(k, None)

        local_types = _weighted_choices(rng, change_attr, len(change_positions))
        pool["local"] = []
        for ctype in local_types:
            pos, amp = change_positions.pop()
            pool["local"].append(
                {"type": ctype, "position_start": pos, "amplitude": amp}
            )

        if "no periodic fluctuation" not in pool["seasonal"]["type"] and seq_len >= 24:
            if seq_len <= 64:
                pool["frequency"] = {"type": "low frequency"}
            else:
                pool["frequency"] = {
                    "type": _weighted_choice(rng, overall["frequency"])
                }
        else:
            pool["frequency"] = {"type": "no periodicity"}

        if seq_len <= 32:
            pool["noise"] = {"type": "almost no noise"}
        else:
            pool["noise"] = {"type": _weighted_choice(rng, overall["noise"])}
        pool["seq_len"] = seq_len
        return pool

    def generate_controlled_attributes(
        self,
        attribute_set: dict,
        change_positions: Optional[Sequence[Tuple[Optional[int], Optional[float]]]] = None,
        seq_len: int = 512,
    ) -> dict:
        """Metric-conditioned sampling from a per-metric attribute config
        (reference: generate.py:159-208; shape of attribute_set per
        config/metric_set.json via attribute_utils.py)."""
        rng = self.rng
        if change_positions is None:
            change_positions = [(None, None)] * int(rng.integers(0, 4))
        change_positions = list(change_positions)
        desc: dict = {}

        s_attrs = list(attribute_set["seasonal"]["attributes"])
        s_w = {
            a: ALL_ATTRIBUTE_SET["overall_attribute"]["seasonal"][a] for a in s_attrs
        }
        desc["seasonal"] = {
            "type": _weighted_choice(rng, s_w),
            "amplitude": rng.uniform(
                attribute_set["seasonal"]["amplitude"]["min"],
                attribute_set["seasonal"]["amplitude"]["max"],
            ),
        }

        t_attrs = list(attribute_set["trend"]["attributes"])
        if not self.config.enable_multiple_trend and "multiple" in t_attrs:
            t_attrs.remove("multiple")
            if not t_attrs:
                t_attrs = ["increase", "decrease", "keep steady"]
        t_w = {a: ALL_ATTRIBUTE_SET["overall_attribute"]["trend"][a] for a in t_attrs}
        desc["trend"] = {
            "type": _weighted_choice(rng, t_w),
            "start": rng.uniform(
                attribute_set["trend"]["start"]["min"],
                attribute_set["trend"]["start"]["max"],
            ),
            "amplitude": rng.uniform(
                attribute_set["trend"]["amplitude"]["min"],
                attribute_set["trend"]["amplitude"]["max"],
            ),
        }

        c_attrs = list(attribute_set["change"]["attributes"])
        c_w = {a: ALL_ATTRIBUTE_SET["change"][a] for a in c_attrs}
        desc["local"] = [
            {
                "type": ctype,
                "position_start": None,
                "amplitude": rng.uniform(
                    attribute_set["change"]["amplitude"]["min"],
                    attribute_set["change"]["amplitude"]["max"],
                ),
            }
            for ctype in _weighted_choices(rng, c_w, len(change_positions))
        ]

        if "no periodic fluctuation" not in desc["seasonal"]["type"]:
            period = max(
                rng.uniform(
                    attribute_set["seasonal"]["period"]["min"],
                    attribute_set["seasonal"]["period"]["max"],
                ),
                6,
            )
            kind = "high frequency" if period < seq_len // 8 else "low frequency"
            desc["frequency"] = {"type": kind, "period": round(period, 1)}
        else:
            desc["frequency"] = {"type": "no periodicity"}

        n_attrs = list(attribute_set["noise"]["attributes"])
        n_w = {a: ALL_ATTRIBUTE_SET["overall_attribute"]["noise"][a] for a in n_attrs}
        desc["noise"] = {"type": _weighted_choice(rng, n_w)}
        desc["seq_len"] = seq_len
        return desc

    # ------------------------------------------------------------------
    # Wave primitives
    # ------------------------------------------------------------------

    def seasonal_wave(
        self,
        period: float,
        amplitude_list: Sequence[float],
        split_points: Sequence[int],
        seq_len: int,
        wave_type: Optional[str] = None,
    ) -> np.ndarray:
        """sin (with harmonics + amplitude drift) / square / triangle wave
        with per-segment amplitude, smoothed with a 5-point running mean
        (reference: generate.py:210-262)."""
        rng = self.rng
        t = np.linspace(0, seq_len, seq_len)
        data = np.zeros(seq_len)
        base_freq = 1 / period

        amp = np.zeros(seq_len)
        for i, a in enumerate(amplitude_list):
            amp[split_points[i] : split_points[i + 1]] = a
        # In-place cascading 5-point smoothing, as the reference does.
        w = 5
        for i in range(seq_len - w):
            amp[i + w // 2] = np.mean(amp[i : i + w])

        if wave_type is None:
            wave_type = str(rng.choice(["sin", "square", "triangle"], p=[0.7, 0.15, 0.15]))

        if wave_type == "sin":
            num_harmonics = int(rng.integers(1, max(2, min(int(period) // 6, 10))))
            for n in range(1, num_harmonics + 1):
                phase = rng.uniform(0, 2 * np.pi)
                drift = 1 + rng.uniform(0, 0.05) * np.sin(
                    rng.uniform(1, 3) * np.pi * t / seq_len + rng.uniform(0, 2 * np.pi)
                )
                data += (amp / n * drift) * np.sin(
                    2 * np.pi * base_freq * n * t + phase
                )
        elif wave_type == "square":
            start = rng.uniform(0, 0.3)
            duration = rng.uniform(0.1, 0.3)
            cycle_pos = (t % period) / period
            on = (cycle_pos >= start) & (cycle_pos < start + duration)
            data = np.where(on, amp, 0.0)
        else:  # triangle
            start = rng.uniform(0, 0.3)
            duration = rng.uniform(0.1, 0.6)
            end = start + duration
            cycle_pos = (t % period) / period
            in_ramp = (cycle_pos >= start) & (cycle_pos < end)
            first_half = cycle_pos < (start + end) / 2
            up = amp * 2 * (cycle_pos - start) / duration
            down = amp * 2 * (end - cycle_pos) / duration
            data = np.where(in_ramp, np.where(first_half, up, down), 0.0)

        data = data / (data.max() - data.min() + 1e-7) * max(amplitude_list)
        return data - np.mean(data)

    def sin_noise(self, amplitude: float, seq_len: int) -> np.ndarray:
        """200-harmonic colored noise (reference: generate.py:264-279)."""
        rng = self.rng
        t = np.linspace(0, seq_len, seq_len)
        freqs = rng.uniform(50 / seq_len, 200 / seq_len, 200)
        phases = rng.uniform(0, 2 * np.pi, 200)
        weights = rng.uniform(0.3, 1.0, 200)
        data = (weights[:, None] * np.sin(freqs[:, None] * t[None] + phases[:, None])).sum(0)
        data = data / (data.max() - data.min() + 1e-7) * amplitude
        return data - np.mean(data)

    def split_points(self, seq_len: int, num_segments: int) -> List[int]:
        """Random segment boundaries with min segment length seq/(2n)
        (reference: generate.py:420-440)."""
        if num_segments < 1:
            raise ValueError("Number of segments must be at least 1.")
        if seq_len < num_segments:
            raise ValueError("Sequence length must be >= number of segments.")
        min_len = seq_len / num_segments / 2
        pts = [0]
        for _ in range(num_segments - 1):
            lo = pts[-1] + min_len
            hi = seq_len - (num_segments - len(pts)) * min_len
            if lo >= hi:
                raise ValueError("Cannot generate split points satisfying constraints.")
            pts.append(int(self.rng.uniform(lo, hi)))
        pts.append(seq_len)
        return pts

    # ------------------------------------------------------------------
    # Composition stages
    # ------------------------------------------------------------------

    def _apply_seasonal(
        self, pool: dict, overall_amplitude: float, seq_len: int
    ) -> np.ndarray:
        rng = self.rng
        y = np.zeros(seq_len)
        stype = pool["seasonal"]["type"]
        if "no period" not in stype:
            wave_type = None if stype == "periodic fluctuation" else stype.split(" ")[0]
            if "amplitude" not in pool["seasonal"]:
                num = int(rng.integers(1, 4)) if self.config.enable_multiple_seasonal else 1
                amp = [rng.uniform(1.0, 2.0) * overall_amplitude for _ in range(num)]
                splits = self.split_points(seq_len, num)
            else:
                amp = [pool["seasonal"]["amplitude"]]
                splits = [0, seq_len]
            y += self.seasonal_wave(
                pool["frequency"]["period"], amp, splits, seq_len, wave_type
            )
            pool["seasonal"]["detail"] = f"The time series is showing {stype}: "
            pool["seasonal"]["segments"] = []
            for i, a in enumerate(amp):
                seg = {
                    "amplitude": round(a, 2),
                    "position_start": splits[i],
                    "position_end": splits[i + 1],
                    "description": (
                        f"the amplitude of the periodic fluctuation is {a:.1f} "
                        f"between point {splits[i]} and point {splits[i + 1]}"
                    ),
                }
                pool["seasonal"]["segments"].append(seg)
                pool["seasonal"]["detail"] += seg["description"] + ", "
            pool["seasonal"]["detail"] = pool["seasonal"]["detail"][:-2] + ". "
        elif stype == "no periodic fluctuation":
            pool["seasonal"]["segments"] = []
            pool["seasonal"]["detail"] = (
                f"No periodic fluctuations observed, showing {stype}. "
            )
        return y

    def _apply_trend(
        self,
        pool: dict,
        y: np.ndarray,
        overall_amplitude: float,
        overall_bias: float,
        seq_len: int,
    ) -> np.ndarray:
        rng = self.rng
        trend = pool["trend"]["type"]
        amplitude = pool["trend"].get(
            "amplitude", rng.uniform(0.8, 3.0) * overall_amplitude
        )
        bias = pool["trend"].get("start", overall_bias)

        if trend == "decrease":
            y = y + changes_lib.easing_change(rng, seq_len, -amplitude, False) + bias
            pool["trend"]["detail"] = (
                "From the perspective of the slope, the overall trend is decreasing. "
            )
            pool["trend"]["trend_list"] = [("decrease", 0, seq_len - 1)]
        elif trend == "increase":
            y = y + changes_lib.easing_change(rng, seq_len, amplitude, False) + bias
            pool["trend"]["detail"] = (
                "From the perspective of the slope, the overall trend is increasing. "
            )
            pool["trend"]["trend_list"] = [("increase", 0, seq_len - 1)]
        elif trend == "multiple":
            while True:
                points = trends_lib.generate_random_points(rng, seq_len)[0]
                tl = trends_lib.generate_trend_list(points, seq_len)
                if len(tl) > 1:
                    break
            y = y + trends_lib.generate_trend_curve(rng, seq_len, points)[1] * amplitude
            pool["trend"]["detail"] = (
                "From the perspective of the slope, the overall trend contains "
                "multiple different segments: "
                + trends_lib.generate_trend_prompt(points)
            )
            pool["trend"]["trend_list"] = tl
        else:  # keep steady
            y = y + bias
            pool["trend"]["detail"] = (
                "From the perspective of the slope, the overall trend is steady. "
            )
            pool["trend"]["trend_list"] = [("keep steady", 0, seq_len - 1)]

        phase_changes = [
            c["type"]
            for c in pool["local"]
            if "increase" in c["type"] or "decrease" in c["type"]
        ]
        if phase_changes:
            pool["trend"]["detail"] += (
                "However, local phase changes were observed, including: "
                + ", ".join(phase_changes)
                + ". "
            )
        pool["trend"]["start"] = round(float(y[0]), 2)
        pool["trend"]["amplitude"] = round(float(y[-1] - y[0]), 2)
        pool["trend"]["detail"] += (
            f"The value of time series starts from around {float(y[0]):.2f} and "
            f"ends at around {float(y[-1]):.2f}, with an overall amplitude of "
            f"{float(y[-1] - y[0]):.2f}. "
        )
        return y

    def _apply_noise(
        self, pool: dict, y: np.ndarray, overall_amplitude: float, seq_len: int
    ) -> np.ndarray:
        rng = self.rng
        max_change = float(np.abs(np.max(y) - np.min(y)))
        level = pool["noise"]["type"]
        if level == "noisy":
            if (
                rng.random() > 0.5
                and max_change > overall_amplitude / 2
                and pool["frequency"]["type"] == "no periodicity"
            ):
                noise = self.sin_noise(0.2 * overall_amplitude, seq_len)
                noise += rng.normal(0, 0.03 * overall_amplitude, seq_len)
                std = round(float(np.std(noise)), 3)
                pool["noise"]["detail"] = (
                    "There is a irregular fluctuating noise, indicating a noisy curve: "
                )
            else:
                std = rng.uniform(0.03, 0.15) * overall_amplitude
                noise = rng.normal(0, std, seq_len)
                pool["noise"]["detail"] = (
                    "There is a random noise, indicating a noisy curve: "
                )

            if self.config.enable_multiple_noise:
                num = int(rng.integers(1, 4))
                pool["noise"]["segments"] = []
                splits = self.split_points(seq_len, num)
                for i in range(num):
                    a, b = splits[i], splits[i + 1]
                    mult = rng.uniform(0.1, 5.0)
                    noise[a:b] *= mult
                    seg = {
                        "position_start": a,
                        "position_end": b,
                        "amplitude": round(mult * std, 2),
                        "description": (
                            f"the noise std is {mult * std:.2f} between point "
                            f"{a} and point {b}"
                        ),
                    }
                    pool["noise"]["segments"].append(seg)
                    pool["noise"]["detail"] += seg["description"] + ", "
                pool["noise"]["detail"] = pool["noise"]["detail"][:-2] + ". "
            else:
                mult = rng.uniform(0.1, 5.0)
                noise *= mult
                pool["noise"]["std"] = round(mult * std, 2)
                pool["noise"]["detail"] = (
                    f"The overall noise standard deviation is around "
                    f"{mult * std:.2f}, indicating a large noisy curve."
                )
        else:  # almost no noise
            if max_change > overall_amplitude / 2:
                std = rng.uniform(0.0, 0.001) * overall_amplitude
            else:
                std = 0.0
            noise = rng.normal(0, std, seq_len)
            pool["noise"]["std"] = round(std, 3)
            pool["noise"]["detail"] = (
                f"The overall noise standard deviation is around {std:.2f}, very "
                "small compared the overall change of the curve. The curve is "
                "overall smooth with almost no noise. "
            )
        return noise

    # ------------------------------------------------------------------
    # Main entry
    # ------------------------------------------------------------------

    def generate(self, attribute_pool: dict, seq_len: int = 512):
        """Compose seasonal + local + trend + noise; back-fill exact labels
        (reference: generate.py:442-549)."""
        rng = self.rng
        pool = attribute_pool

        if not self.config.enable_multiple_trend:
            if "no period" not in pool["seasonal"]["type"]:
                pool["seasonal"]["type"] = "periodic fluctuation"
            if pool["trend"]["type"] == "multiple":
                pool["trend"]["type"] = str(
                    rng.choice(["increase", "decrease", "keep steady"])
                )

        # Frequency realization.
        period = float(seq_len)
        if "frequency" in pool:
            ftype = pool["frequency"]["type"]
            if "period" in pool["frequency"] and pool["frequency"]["period"]:
                period = float(pool["frequency"]["period"])
            elif ftype == "high frequency":
                period = rng.uniform(max(seq_len // 16, 6), seq_len // 8)
            elif ftype == "low frequency":
                period = rng.uniform(max(seq_len // 8, 6), seq_len // 3)
            if ftype == "no periodicity":
                pool["frequency"]["period"] = 0.0
                pool["frequency"]["detail"] = (
                    "No significant periodic fluctuations observed, overall "
                    "almost no periodicity. "
                )
            else:
                pool["frequency"]["period"] = round(period, 1)
                pool["frequency"]["detail"] = (
                    f"Each fluctuation period is approximately {period:.1f} "
                    f"points, thus the overall fluctuation is {ftype}. "
                )

        # Overall scale: amplitude exponent spans ~9 decades
        # (reference: generate.py:509-513) — value preservation matters.
        if "overall_amplitude" in pool and "overall_bias" in pool:
            overall_amplitude = pool["overall_amplitude"]
            overall_bias = pool["overall_bias"]
        else:
            e = int(
                rng.choice(
                    [-2, -1, 0, 1, 2, 3, 4, 5, 6, 7],
                    p=[0.1, 0.2, 0.2, 0.3, 0.1, 0.04, 0.03, 0.02, 0.008, 0.002],
                )
            )
            overall_amplitude = round(rng.uniform(10.0 ** (e - 1), 10.0 ** (e + 1)), 2)
            overall_bias = round(rng.uniform(-(10.0 ** (e + 1)), 10.0 ** (e + 1)), 2)
            pool["overall_amplitude"] = overall_amplitude
            pool["overall_bias"] = overall_bias

        y = self._apply_seasonal(pool, overall_amplitude, seq_len)

        local_delta, realized = changes_lib.apply_local_changes(
            rng, pool["local"], overall_amplitude, seq_len,
            verbose=self.config.local_change_verbose,
        )
        pool["local"] = realized
        y = y + local_delta

        y = self._apply_trend(pool, y, overall_amplitude, overall_bias, seq_len)

        # Substitute <|idx|> with realized values BEFORE adding noise.
        pattern = re.compile(r"<\|(\d+)\|>")
        for c in pool["local"]:
            c["detail"] = pattern.sub(
                lambda m: f"{y[min(int(m.group(1)), seq_len - 1)]:.2f}", c["detail"]
            )

        y = y + self._apply_noise(pool, y, overall_amplitude, seq_len)

        pool["statistics"] = {
            "mean": round(float(np.mean(y)), 2),
            "std": round(float(np.std(y)), 2),
            "max": round(float(np.max(y)), 2),
            "min": round(float(np.min(y)), 2),
            "max_pos": int(np.argmax(y)),
            "min_pos": int(np.argmin(y)),
        }
        pool["seq_len"] = seq_len
        return y, pool


# ---------------------------------------------------------------------------
# Ground-truth renderers (pure functions of series + pool)
# ---------------------------------------------------------------------------

def attribute_to_text(
    time_series: np.ndarray,
    attribute_pool: dict,
    generate_values: bool = True,
    include_attributes: Optional[List[str]] = None,
) -> str:
    """Render the exact textual ground truth
    (reference: generate.py:551-599)."""
    include = list(
        include_attributes
        or ["length", "trend", "periodicity", "frequency", "noise", "local", "statistic"]
    )
    if not generate_values and "statistic" in include:
        include.remove("statistic")
    elif generate_values and "statistic" not in include:
        include.append("statistic")

    seq_len = len(time_series)
    out = ""
    if "length" in include:
        out += f"The length of the time series is {seq_len}. "
    if "trend" in include:
        out += attribute_pool["trend"]["detail"]
    if "periodicity" in include:
        out += attribute_pool["seasonal"]["detail"]
    if "no" not in attribute_pool["seasonal"]["type"] and "frequency" in include:
        out += attribute_pool["frequency"]["detail"]
    if "noise" in include:
        out += attribute_pool["noise"]["detail"]
    if "local" in include:
        if attribute_pool["local"]:
            out += (
                "In terms of local characteristics, "
                + ";".join(
                    f"{c['detail']}, forming a {c['type']}"
                    for c in attribute_pool["local"]
                )
                + ". "
            )
        else:
            out += "No local characteristics are found. "
    if "statistic" in include:
        segments, seg_means = _segment_means(time_series)
        out += (
            f"Specific data details: The time series is divided into {segments} "
            f"segments, with the approximate mean values for each "
            f"{seq_len // segments}-point interval being: {seg_means}. The "
            f"maximum value of the entire series is "
            f"{round(float(np.max(time_series)), 2)}, and the minimum value is "
            f"{round(float(np.min(time_series)), 2)}."
        )
    return out


def _segment_means(time_series: np.ndarray) -> Tuple[int, List[float]]:
    seq_len = len(time_series)
    if seq_len >= 64:
        segments = 32
    elif seq_len >= 32:
        segments = 16
    else:
        segments = seq_len
    step = seq_len // segments
    means = [
        round(float(np.mean(time_series[i : i + step])), 2)
        for i in range(0, seq_len, step)
    ]
    return segments, means


def attribute_to_caption(
    time_series: np.ndarray,
    attribute_pool: dict,
    generate_values: bool = True,
    rng: Optional[np.random.Generator] = None,
) -> str:
    """Chronological narrative interleaving trend segments with local changes
    (reference: generate.py:602-669)."""
    rng = rng or np.random.default_rng()
    seq_len = len(time_series)
    segments, seg_means = _segment_means(time_series)
    out = f"The length of the time series is {seq_len}. "
    out += attribute_pool["seasonal"]["detail"]
    if "no" not in attribute_pool["seasonal"]["type"]:
        out += attribute_pool["frequency"]["detail"]
    out += attribute_pool["noise"]["detail"]

    out += (
        "In terms of the trend and changes of this time series: At the beginning, "
    )
    by_start = {int(c["position_start"]): c for c in attribute_pool["local"]}
    trend_list = attribute_pool["trend"]["trend_list"]
    cur = 0
    while cur < seq_len - 1:
        later_changes = sorted(k for k in by_start if k >= cur)
        later_trends = sorted(t[1] for t in trend_list if t[1] > cur)
        cur_trend = [t for t in trend_list if t[1] <= cur < t[2]][0]

        if later_changes and (not later_trends or later_changes[0] < later_trends[0]):
            nxt = later_changes[0]
            change = by_start[nxt]
            if nxt > cur:
                out += (
                    f"from point {cur} to {nxt}, the time series {cur_trend[0]} "
                    f"with values from {float(time_series[cur]):.2f} to "
                    f"{float(time_series[nxt]):.2f}; "
                )
            out += (
                f"from point {change['position_start']} to point "
                f"{change['position_end']}, {change['detail']}, forming a "
                f"{change['type']}; "
            )
            cur = int(change["position_end"])
        elif later_trends:
            nxt = later_trends[0]
            nxt_trend = [t for t in trend_list if t[1] == nxt][0]
            if nxt > cur:
                out += (
                    f"from point {cur} to {nxt}, the time series {cur_trend[0]} "
                    f"with values from {float(time_series[cur]):.2f} to "
                    f"{float(time_series[nxt]):.2f}, and then the trend of the "
                    f"time series changes to {nxt_trend[0]}; "
                )
            cur = nxt
        else:
            nxt = seq_len - 1
            if nxt > cur:
                out += (
                    f"finally, from point {cur} to {nxt}, the time series "
                    f"{cur_trend[0]} with values from "
                    f"{float(time_series[cur]):.2f} to "
                    f"{float(time_series[nxt]):.2f}. "
                )
            break

    if generate_values:
        out += (
            f"Specific data details: The time series is divided into {segments} "
            f"segments, with the approximate mean values for each "
            f"{seq_len // segments}-point interval being: {seg_means}. The "
            f"maximum value of the entire series is "
            f"{round(float(np.max(time_series)), 2)}, and the minimum value is "
            f"{round(float(np.min(time_series)), 2)}. The start value is "
            f"{float(time_series[0]):.2f}, the end value if "
            f"{float(time_series[-1]):.2f}. "
        )
        for _ in range(5):
            p = int(rng.integers(0, seq_len))
            out += f"The value of point {p} is {float(time_series[p]):.2f}. "
    return out


def prompt_to_inference(timeseries: Sequence[np.ndarray], prompt: str) -> str:
    """Inline series values into the prompt as text
    (reference: generate.py:671-682)."""
    parts = prompt.split("<ts><ts/>")
    out = parts[0]
    for i in range(len(parts) - 1):
        ts = timeseries[i]
        if isinstance(ts, np.ndarray):
            ts = ts.tolist()
        ts = [[round(float(v), 4) for v in item] for item in ts]
        out += f"<ts>{ts}<ts/>" + parts[i + 1]
    return out
