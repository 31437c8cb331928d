"""Native time-series analysis tools for the ReAct-agent baseline.

The port's copy of ``chatts_tpu/eval/ts_tools.py``: the same numpy code, so a seed
gives the same bits in both packages.

The reference leans on sktime (ROCKET), adtk (AutoregressionAD), and
statsmodels (STL) — none of which are first-party or in-environment here
(reference: evaluation/react_agent.py:19-26, SURVEY §2.4 "baseline-only").
These are self-contained numpy implementations with the same observable
behavior:

* :func:`find_period` — ACF inflection-peak period finder (same algorithm as
  reference react_agent.py:50-67).
* :func:`stl_decompose` — classical seasonal-trend decomposition (centered
  moving-average trend + periodic-mean seasonal); stands in for statsmodels
  STL.
* :func:`ar_anomaly_detect` — autoregressive residual outlier detection with
  the IQR rule (adtk AutoregressionAD analog: regress x_t on recent lags,
  flag residuals outside Q1-3*IQR / Q3+3*IQR).
* :class:`RocketClassifier` — random convolutional kernel transform (PPV +
  max features) with a closed-form ridge classifier; replaces sktime's
  RocketClassifier for the 64-pt change-type windows.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


def find_period(
    signal: np.ndarray, min_period: int = 10, amplitude_threshold: float = 0.1
) -> Optional[int]:
    """ACF inflection-peak period finder (reference:
    react_agent.py:50-67)."""
    signal = np.asarray(signal, dtype=np.float64)
    acf = np.correlate(signal, signal, "full")[-len(signal):]
    inflection = np.diff(np.sign(np.diff(acf)))
    peaks = (inflection < 0).nonzero()[0] + 1
    if len(peaks) == 0:
        return None
    max_acf = acf[peaks].max()
    valid = [p for p in peaks if acf[p] >= amplitude_threshold * max_acf]
    valid = [p for p in valid if p >= min_period]
    if not valid:
        return None
    return int(valid[int(np.argmax(acf[valid]))])


@dataclasses.dataclass
class STLResult:
    trend: np.ndarray
    seasonal: np.ndarray
    resid: np.ndarray


def _moving_average(x: np.ndarray, window: int) -> np.ndarray:
    """Centered moving average with edge padding."""
    window = max(3, int(window) | 1)  # odd
    pad = window // 2
    padded = np.pad(x, pad, mode="edge")
    kernel = np.ones(window) / window
    return np.convolve(padded, kernel, mode="valid")


def stl_decompose(ts: np.ndarray, period: int, robust: bool = True) -> STLResult:
    """Classical decomposition: trend = centered MA over one period,
    seasonal = per-phase mean (median when robust) of the detrended series,
    residual = remainder."""
    ts = np.asarray(ts, dtype=np.float64)
    n = len(ts)
    period = max(2, min(int(period), max(2, n // 2)))
    trend = _moving_average(ts, period)
    detrended = ts - trend
    agg = np.median if robust else np.mean
    phase_means = np.array([
        agg(detrended[phase::period]) if len(detrended[phase::period]) else 0.0
        for phase in range(period)
    ])
    phase_means = phase_means - phase_means.mean()
    seasonal = np.tile(phase_means, n // period + 1)[:n]
    resid = ts - trend - seasonal
    return STLResult(trend=trend, seasonal=seasonal, resid=resid)


def ar_anomaly_detect(
    ts: np.ndarray, n_lags: int = 1, c: float = 3.0
) -> np.ndarray:
    """AR residual outlier detection (adtk AutoregressionAD analog).

    Fits x_t ~ [x_{t-1}..x_{t-n_lags}, 1] by least squares, flags residuals
    outside [Q1 - c*IQR, Q3 + c*IQR].  Returns a boolean array (first
    ``n_lags`` entries False).
    """
    ts = np.asarray(ts, dtype=np.float64)
    n = len(ts)
    out = np.zeros(n, dtype=bool)
    if n <= n_lags + 2:
        return out
    X = np.stack(
        [ts[n_lags - lag - 1 : n - lag - 1] for lag in range(n_lags)] + [np.ones(n - n_lags)],
        axis=1,
    )
    y = ts[n_lags:]
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    resid = y - X @ coef
    q1, q3 = np.percentile(resid, [25, 75])
    iqr = q3 - q1
    if iqr == 0:
        iqr = np.std(resid) or 1e-9
    lower, upper = q1 - c * iqr, q3 + c * iqr
    out[n_lags:] = (resid < lower) | (resid > upper)
    return out


def anomaly_block_starts(flags: np.ndarray) -> List[int]:
    """Start index of each contiguous anomalous block (reference:
    react_agent.py:95-101)."""
    starts = []
    for i in range(len(flags)):
        if flags[i] and (i == 0 or not flags[i - 1]):
            starts.append(i)
    return starts


# ---------------------------------------------------------------------------
# ROCKET: random convolutional kernels + ridge classifier
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Kernels:
    weights: np.ndarray  # (K, 9)
    biases: np.ndarray  # (K,)
    dilations: np.ndarray  # (K,)
    paddings: np.ndarray  # (K,)


def _sample_kernels(
    rng: np.random.Generator, num_kernels: int, input_length: int
) -> _Kernels:
    length = 9
    weights = rng.normal(0, 1, (num_kernels, length))
    weights = weights - weights.mean(axis=1, keepdims=True)
    biases = rng.uniform(-1, 1, num_kernels)
    max_exp = np.log2((input_length - 1) / (length - 1))
    dilations = np.floor(
        2 ** rng.uniform(0, max(max_exp, 0), num_kernels)
    ).astype(int)
    paddings = np.where(
        rng.integers(0, 2, num_kernels) == 1,
        ((length - 1) * dilations) // 2,
        0,
    )
    return _Kernels(weights, biases, dilations, paddings)


def _apply_kernels(X: np.ndarray, kernels: _Kernels) -> np.ndarray:
    """X (N, L) -> features (N, 2K): PPV and max per kernel."""
    n, l = X.shape
    k = len(kernels.biases)
    feats = np.zeros((n, 2 * k))
    for ki in range(k):
        d = int(kernels.dilations[ki])
        p = int(kernels.paddings[ki])
        w = kernels.weights[ki]
        b = kernels.biases[ki]
        span = (len(w) - 1) * d
        padded = np.pad(X, ((0, 0), (p, p))) if p else X
        out_len = padded.shape[1] - span
        if out_len <= 0:
            continue
        conv = np.zeros((n, out_len))
        for wi, wv in enumerate(w):
            conv += wv * padded[:, wi * d : wi * d + out_len]
        conv = conv + b
        feats[:, 2 * ki] = (conv > 0).mean(axis=1)  # PPV
        feats[:, 2 * ki + 1] = conv.max(axis=1)
    return feats


class RocketClassifier:
    """ROCKET transform + ridge classifier (sktime RocketClassifier analog).

    Trains in closed form on one-hot targets; predicts argmax.  Persisted as
    a single ``.npz`` (reference persists ``result/rocket.zip``).
    """

    def __init__(self, num_kernels: int = 1000, alpha: float = 1.0, seed: int = 0):
        self.num_kernels = num_kernels
        self.alpha = alpha
        self.seed = seed
        self.kernels: Optional[_Kernels] = None
        self.coef: Optional[np.ndarray] = None
        self.classes: Optional[np.ndarray] = None
        self._mu: Optional[np.ndarray] = None
        self._sigma: Optional[np.ndarray] = None

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RocketClassifier":
        X = np.asarray(X, dtype=np.float64)
        rng = np.random.default_rng(self.seed)
        self.kernels = _sample_kernels(rng, self.num_kernels, X.shape[1])
        feats = _apply_kernels(X, self.kernels)
        self._mu = feats.mean(axis=0)
        self._sigma = feats.std(axis=0)
        self._sigma[self._sigma == 0] = 1.0
        feats = (feats - self._mu) / self._sigma
        self.classes, y_idx = np.unique(y, return_inverse=True)
        onehot = np.eye(len(self.classes))[y_idx] * 2 - 1
        gram = feats.T @ feats + self.alpha * np.eye(feats.shape[1])
        self.coef = np.linalg.solve(gram, feats.T @ onehot)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 3:  # (N, 1, L) sktime-style input
            X = X[:, 0, :]
        feats = _apply_kernels(X, self.kernels)
        feats = (feats - self._mu) / self._sigma
        scores = feats @ self.coef
        return self.classes[np.argmax(scores, axis=1)]

    def score(self, X: np.ndarray, y: np.ndarray) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y)))

    def save(self, path: str) -> None:
        np.savez(
            path,
            weights=self.kernels.weights,
            biases=self.kernels.biases,
            dilations=self.kernels.dilations,
            paddings=self.kernels.paddings,
            coef=self.coef,
            classes=self.classes,
            mu=self._mu,
            sigma=self._sigma,
        )

    @classmethod
    def load(cls, path: str) -> "RocketClassifier":
        data = np.load(path, allow_pickle=True)
        clf = cls(num_kernels=len(data["biases"]))
        clf.kernels = _Kernels(
            data["weights"], data["biases"], data["dilations"], data["paddings"]
        )
        clf.coef = data["coef"]
        clf.classes = data["classes"]
        clf._mu = data["mu"]
        clf._sigma = data["sigma"]
        return clf


# ---------------------------------------------------------------------------
# Tool-level helpers (prompt-producing, reference tool behavior)
# ---------------------------------------------------------------------------

def stl_tool(ts: np.ndarray) -> str:
    """STL narration (reference: react_agent.py:49-88)."""
    ts = np.asarray(ts, dtype=np.float64)
    period = find_period(ts)
    result = stl_decompose(ts, period if period is not None else 20)
    step = max(len(result.trend) // 10, 1)
    prompt = (
        "The STL decomposition of the time series is as follows: "
        f"From the trend perspective, the difference between the rightmost "
        f"and leftmost points is "
        f"{round(float(result.trend[-1] - result.trend[0]), 2)}, the start "
        f"point of the trend is around {round(float(result.trend[0]), 2)}."
        f"The 10 equal parts of the trend are as follows: "
        f"{[round(float(result.trend[i]), 2) for i in range(0, len(result.trend), step)]}. "
        "Please analyze the trend characteristics of the time series "
        "considering the overall changes in the time series. "
    )
    if period is not None:
        prompt += (
            f"From the seasonal perspective, the period is around {period}, "
            f"the maximum seasonal value is "
            f"{round(float(np.max(result.seasonal)), 2)}, the minimum "
            f"seasonal value is {round(float(np.min(result.seasonal)), 2)}. "
        )
    else:
        prompt += (
            "From the seasonal perspective, no significant seasonal "
            "fluctuation is found. "
        )
    prompt += (
        f"From the noise perspective, the standard deviation is "
        f"{round(float(np.std(result.resid)), 3)}. "
    )
    return prompt


def anomaly_detection_tool(ts: np.ndarray) -> str:
    flags = ar_anomaly_detect(np.asarray(ts))
    starts = anomaly_block_starts(flags)
    if starts:
        return f"The anomalous points are {starts}."
    return "No anomaly is detected."


def anomaly_detection_multi_tool(timeseries: List, cols: List[str]) -> str:
    results = []
    for col, ts in zip(cols, timeseries):
        starts = anomaly_block_starts(ar_anomaly_detect(np.asarray(ts)))
        if starts:
            results.append(f"- For {col}, the anomalous points are {starts}.")
        else:
            results.append(f"- For {col}, no anomaly is detected.")
    return "The detection results are: \n" + "\n".join(results)


def correlation_tool(timeseries: List, src_idx: int, cols: List[str]) -> str:
    min_len = min(len(t) for t in timeseries)
    aligned = np.stack([np.asarray(t)[:min_len] for t in timeseries])
    prompt = (
        f"The pearson correlation between {cols[src_idx]} and other metrics "
        "are as follows: "
    )
    for j in range(len(cols)):
        if j == src_idx:
            continue
        corr = np.corrcoef(aligned[src_idx], aligned[j])[0, 1]
        prompt += (
            f"The correlation between {cols[src_idx]} and {cols[j]} is "
            f"{corr:.3f}. "
        )
    return prompt


def trend_correlation_tool(timeseries: List, src_idx: int, cols: List[str]) -> str:
    """STL-trend pearson correlation with a 0.7 threshold (reference:
    react_agent.py:200-247)."""
    min_len = min(len(t) for t in timeseries)
    aligned = [np.asarray(t)[:min_len] for t in timeseries]
    trends = []
    for ts in aligned:
        period = find_period(ts)
        trends.append(stl_decompose(ts, period if period is not None else 20).trend)
    prompt = f"Trend correlations for {cols[src_idx]}:\n"
    high = []
    for i, trend in enumerate(trends):
        corr = np.corrcoef(trends[src_idx], trend)[0, 1]
        prompt += f"- {cols[i]}: {corr:.3f}\n"
        if corr > 0.7:
            high.append(cols[i])
    prompt += (
        "Therefore, time series with high correlation (>0.7) are: "
        + ", ".join(high)
    )
    return prompt


def fluctuation_correlation_tool(
    timeseries: List, src_idx: int, cols: List[str]
) -> str:
    """Anomaly-position matching with 5% tolerance (reference:
    react_agent.py:249-300)."""
    seq_len = min(len(t) for t in timeseries)
    aligned = [np.asarray(t)[:seq_len] for t in timeseries]
    tolerance = int(seq_len * 0.05)
    positions = [
        set(np.where(ar_anomaly_detect(ts))[0].tolist()) for ts in aligned
    ]
    src = positions[src_idx]
    prompt = f"Fluctuation correlation for {cols[src_idx]}:\n"
    matches = {}
    for j, target in enumerate(positions):
        if j == src_idx:
            continue
        matched = sum(
            1
            for pos in src
            if any(
                max(0, pos - tolerance) <= t <= min(seq_len - 1, pos + tolerance)
                for t in target
            )
        )
        matches[cols[j]] = matched / (len(src) or 1)
    for col, ratio in sorted(matches.items(), key=lambda kv: -kv[1]):
        if ratio > 0:
            prompt += (
                f"- {col}: has matching fluctuations, may be correlated with "
                f"{cols[src_idx]}\n"
            )
        else:
            prompt += (
                f"- {col}: no matching fluctuations found, may be not "
                f"correlated with {cols[src_idx]}\n"
            )
    return prompt
