"""ChatTS's prompt processing, for one prompt: the stand-in tokenizer, the sp
encoding of each series and the expansion of each ``<ts><ts/>`` hole.

The stand-in tokenizer is a frozen copy of ``chip_smoke.py``'s
``WordTokenizer``: the repository holds no tokenizer files, so each
whitespace word becomes one id in [10, 400) (CRC32), far below the
placeholder ids.  The benchmark hands the same tokenizer class to the port's
processor.

For each series the processor subtracts the mean, divides by max |x| / 3
where any |x| reaches 3, echoes the offset and scaling as text before the
hole (``[Value Offset: -m|Value Scaling: s]``), and expands the hole into
ceil(L / patch) placeholder ids followed by the end id.
"""
from __future__ import annotations

import zlib
from typing import List, Sequence, Tuple

import numpy as np

TS_PAIR = "<ts><ts/>"


class WordTokenizer:
    """One id in [10, 400) per whitespace word (CRC32)."""

    pad_token_id = 0
    eos_token_id = 1

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        return [10 + zlib.crc32(word.encode()) % 390 for word in text.split()]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return " ".join(f"t{int(i)}" for i in ids)


def sp_encode(series: np.ndarray) -> Tuple[np.ndarray, str]:
    """(the scaled values as float32, the echo text before the hole)."""
    x = np.asarray(series, dtype=np.float64).reshape(-1)
    mean = float(np.mean(x))
    scaled = x - mean
    scale = 1.0
    if np.any(np.abs(scaled) >= 3.0):
        scale = float(np.max(np.abs(scaled)) / 3.0)
        scaled = scaled / scale
    return scaled.astype(np.float32), f"[Value Offset: {-mean:.4f}|Value Scaling: {scale:.4f}]"


def encode(prompt: str, series: Sequence[np.ndarray], patch: int, ts_start: int
           ) -> Tuple[List[int], List[np.ndarray], List[int]]:
    """(token ids, the scaled values of each series, the position of each
    series' first placeholder)."""
    tok = WordTokenizer()
    parts = prompt.split(TS_PAIR)
    if len(parts) - 1 != len(series):
        raise ValueError(f"{len(parts) - 1} holes, {len(series)} series")
    ids = tok.encode(parts[0])
    values, starts = [], []
    for i, s in enumerate(series):
        v, echo = sp_encode(s)
        ids += tok.encode(echo)
        starts.append(len(ids))
        ids += [ts_start] * (-(-len(v) // patch)) + [ts_start + 1]
        ids += tok.encode(parts[i + 1])
        values.append(v)
    return ids, values, starts
