"""Value-Preserved time-series encoding.

Behavioral parity with the reference encoders
(reference: chatts/utils/encoding_utils.py:10-103): per-series mean offset,
3.0-clipped scaling, and — for the ``sp`` method — a value/valid-flag
interleave of shape (2L, 1) whose scale/offset are echoed back into the prompt
text so absolute values remain answerable by the model.

These run on host (numpy) as part of request preprocessing; the device-side
consumer is :mod:`chatts_tpu_torch.models.ts_encoder`.  The port's own copy of
``chatts_tpu/core/encoding.py``, with the parts the port uses.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

TS_BEGIN = "<ts>"
TS_END = "<ts/>"
TS_PAIR = TS_BEGIN + TS_END


def sp_encoding(timeseries: np.ndarray) -> Tuple[np.ndarray, str, Dict[str, float]]:
    """Scale-Preserved encoding: (2L, 1) value/valid interleave + prompt echo."""
    timeseries = np.asarray(timeseries, dtype=np.float64)
    mean = float(np.mean(timeseries))
    scaled = timeseries - mean
    scale_factor = 1.0
    if np.any(np.abs(scaled) >= 3.0):
        scale_factor = float(np.max(np.abs(scaled)) / 3.0)
        scaled = scaled / scale_factor
    prompt = f"[Value Offset: {-mean:.4f}|Value Scaling: {scale_factor:.4f}]{TS_PAIR}"
    encoded = np.stack([scaled, np.ones_like(scaled)], axis=-1).reshape(-1, 1)
    return encoded, prompt, {"offset": -mean, "scale_factor": scale_factor}


def minmax_scale_encoding(
    timeseries: np.ndarray,
) -> Tuple[np.ndarray, str, Dict[str, float]]:
    timeseries = np.asarray(timeseries, dtype=np.float64)
    mean = float(np.mean(timeseries))
    scaled = timeseries - mean
    scale_factor = 1.0
    if np.any(np.abs(scaled) >= 3.0):
        scale_factor = float(np.max(np.abs(scaled)) / 3.0)
        scaled = scaled / scale_factor
    prompt = f"[Offset: {-mean:.4f}|Scaled by: {scale_factor:.4f}]{TS_PAIR}"
    return scaled[:, np.newaxis], prompt, {"offset": -mean, "scale_factor": scale_factor}


def no_encoding(timeseries: np.ndarray) -> Tuple[np.ndarray, str, Dict[str, float]]:
    return np.asarray(timeseries), TS_PAIR, {}


_ENCODERS = {
    "sp": sp_encoding,
    "minmax_scale": minmax_scale_encoding,
    "no": no_encoding,
}


def timeseries_encoding(timeseries: np.ndarray, method: str):
    try:
        return _ENCODERS[method](timeseries)
    except KeyError:
        raise NotImplementedError(
            f"Timeseries encoding method: {method} not implemented!"
        ) from None


def timeseries_to_list(timeseries, digits: int = 6):
    """Recursively round a (possibly nested) series to ``digits`` decimals
    (reference: chatts/utils/encoding_utils.py:88-103)."""
    if isinstance(timeseries, np.ndarray):
        timeseries = timeseries.tolist()
    if not isinstance(timeseries, list):
        return round(float(timeseries), digits)
    if timeseries and isinstance(timeseries[0], (int, float)):
        return [round(float(v), digits) for v in timeseries]
    return [timeseries_to_list(v, digits) for v in timeseries]


def num_patches(series_len: int, patch_size: int) -> int:
    """Token budget of one series: ceil(L / patch_size)
    (reference: chatts/vllm/chatts_vllm.py:100,402)."""
    return -(-series_len // patch_size)
