"""Value-Preserved time-series encoding.

Behavioral parity with the reference encoders
(reference: chatts/utils/encoding_utils.py:10-103): per-series mean offset,
3.0-clipped scaling, and — for the ``sp`` method — a value/valid-flag
interleave of shape (2L, 1) whose scale/offset are echoed back into the prompt
text so absolute values remain answerable by the model.

These run on host (numpy) as part of request preprocessing; the device-side
consumer is :mod:`chatts_tpu_torch.models.ts_encoder`.  The port's own copy of
``chatts_tpu/core/encoding.py``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

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


def sp_decode(encoded: np.ndarray, meta: Dict[str, float]) -> np.ndarray:
    """Invert :func:`sp_encoding` — used by round-trip tests."""
    flat = np.asarray(encoded).reshape(-1, 2)
    valid = flat[:, 1] > 0.5
    values = flat[valid, 0]
    return values * meta["scale_factor"] - meta["offset"]


def eval_prompt_to_encoding(
    prompt: str, timeseries: Sequence[np.ndarray], method: str
) -> Tuple[str, np.ndarray]:
    """Encode every series referenced by a ``<ts><ts/>``-holed prompt.

    Returns the prompt with each hole prefixed by its offset/scale echo plus a
    zero-padded (N, max_len, 1) batch array
    (reference: chatts/utils/encoding_utils.py:65-86).
    """
    parts = prompt.split(TS_PAIR)
    if len(timeseries) != len(parts) - 1:
        raise ValueError(
            f"prompt has {len(parts) - 1} {TS_PAIR} holes but "
            f"{len(timeseries)} series were given"
        )
    result_prompt = parts[0]
    encoded_list: List[np.ndarray] = []
    for i, ts in enumerate(timeseries):
        enc, frag, _ = timeseries_encoding(np.asarray(ts), method)
        result_prompt += frag + parts[i + 1]
        encoded_list.append(enc[np.newaxis])

    max_length = max(arr.shape[1] for arr in encoded_list)
    padded = [
        np.pad(arr, ((0, 0), (0, max_length - arr.shape[1]), (0, 0)))
        for arr in encoded_list
    ]
    return result_prompt, np.concatenate(padded, axis=0)


def timeseries_prompt(prompt: str, timeseries) -> str:
    """Inline raw values as text next to each hole (text-baseline rendering;
    reference: chatts/utils/encoding_utils.py:52-63)."""
    if isinstance(timeseries, np.ndarray):
        timeseries = timeseries.tolist()
    parts = prompt.split(TS_PAIR)
    if len(timeseries) != len(parts) - 1:
        raise ValueError("series count does not match prompt holes")
    result = parts[0]
    for i, ts in enumerate(timeseries):
        rendered = [[round(k, 3) for k in row] for row in list(ts)]
        result += f"{TS_BEGIN}{rendered}{TS_END}" + parts[i + 1]
    return result


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


def num_patches_from_encoded(encoded_len: int, patch_size: int) -> int:
    """Patch count from the (2L, 1) interleave's length: the //2 undoes the
    value/valid interleave (reference: chatts/vllm/chatts_vllm.py:402,419-421)."""
    return (encoded_len // 2 + patch_size - 1) // patch_size
