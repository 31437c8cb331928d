"""The one traffic generator: a traffic file (``traffic/<mix>.json``) of
parameters in, the cell's requests and their schedule out.

A traffic file gives:
- ``loop``: ``"closed"`` (``clients`` clients, each sending its next request
  the moment its last one ends) or ``"open"`` (Poisson arrivals at ``rate``
  requests a second, sent on schedule whatever the engine does);
- ``ramp_s``: seconds of this traffic before the window opens, so that the
  window opens on an engine already under it; ``drain_s``: how long after
  the window the requests due in it may take to finish; ``trace_s``: the
  seconds at the window's end that a traced run profiles;
- ``pool``: how many request shapes are drawn;
- the distributions of ``text_words``, ``series_count``, ``series_len`` and
  ``max_tokens``, each ``{"dist": "loguniform" | "uniform_int", "min", "max"}``;
- ``temperature`` (0 is greedy), and the prompt's ``lead`` and ``ask`` text.

Every seed gets the same set of sizes and of arrival gaps, in another order:
each attribute takes the pool's quantiles (i + 0.5) / pool of its
distribution, shuffled by the seed, and the arrival gaps the quantiles of the
exponential distribution.  The seed changes which shapes meet and in what
order, and every word and value of the prompts, but not the amount of work,
so runs of different seeds spread no more than runs of one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from port_bench.reference.processor import TS_PAIR


@dataclasses.dataclass
class Spec:
    """One request: its prompt, its series and how many tokens it asks for."""

    index: int
    prompt: str
    series: List[np.ndarray]
    max_tokens: int
    temperature: float


def _quantiles(dist: dict, u: np.ndarray) -> np.ndarray:
    lo, hi = float(dist["min"]), float(dist["max"])
    kind = dist["dist"]
    if kind == "loguniform":
        return np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    if kind == "uniform_int":
        return lo + np.floor(u * (hi - lo + 1))
    raise ValueError(f"unknown distribution {kind!r}")


class Traffic:
    """The requests of one run of a traffic mix, drawn from ``seed``."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = int(seed)
        self.loop = mix["loop"]
        if self.loop not in ("closed", "open"):
            raise ValueError(f"loop is 'closed' or 'open', got {self.loop!r}")
        n = int(mix["pool"])
        rng = np.random.default_rng([self.seed, 1])

        def attribute(name: str) -> np.ndarray:
            u = (rng.permutation(n) + 0.5) / n
            return _quantiles(mix[name], u)

        self.words = np.rint(attribute("text_words")).astype(int)
        self.n_series = np.rint(attribute("series_count")).astype(int)
        self.max_tokens = np.rint(attribute("max_tokens")).astype(int)
        self.pool = n
        self._len_u = rng.permutation(n * int(mix["series_count"]["max"]))

    def shape(self, i: int):
        """(text words, series lengths, max_tokens) of request ``i``: the
        pool's shapes, taken in the seed's order and again from the start
        once every one was used."""
        k = i % self.pool
        m = self.n_series[k]
        per = int(self.mix["series_count"]["max"])
        u = (self._len_u[k * per:k * per + m] + 0.5) / len(self._len_u)
        lens = np.rint(_quantiles(self.mix["series_len"], u)).astype(int)
        return int(self.words[k]), [int(x) for x in lens], int(self.max_tokens[k])

    def spec(self, i: int) -> Spec:
        """Request ``i``, its words and values drawn from (seed, i)."""
        words, lens, max_tokens = self.shape(i)
        rng = np.random.default_rng([self.seed, 2, i])
        holes = " ".join(f"metric {j}: {TS_PAIR}" for j in range(len(lens)))
        text = " ".join(f"w{int(x)}" for x in rng.integers(0, 10 ** 6, words))
        prompt = f"{self.mix['lead']} {holes} {self.mix['ask']} {text}"
        series = [rng.normal(0.0, 1.0, n).cumsum() * rng.uniform(0.5, 20.0)
                  + rng.uniform(-100.0, 100.0) for n in lens]
        return Spec(i, prompt, series, max_tokens, float(self.mix["temperature"]))

    def arrivals(self, seconds: float) -> np.ndarray:
        """Open loop: the due times (seconds from the start of the ramp) of
        every request sent over the ramp and a window of ``seconds``."""
        rate = float(self.mix["rate"])
        total = float(self.mix["ramp_s"]) + seconds
        n = max(1, int(math.ceil(rate * total)))
        rng = np.random.default_rng([self.seed, 3])
        u = (rng.permutation(n) + 0.5) / n
        due = np.cumsum(-np.log1p(-u) / rate)
        return due[due < total]

