"""Metric-domain priors: categories -> metrics -> clusters -> attribute ranges.

The port's copy of ``chatts_tpu/datagen/metric_set.py``: the same numpy code, so a seed
gives the same bits in both packages.

The reference ships a 29,390-line ``config/metric_set.json`` domain prior and
flattens it into a metric -> attribute-config lookup
(reference: chatts/utils/attribute_utils.py:19-30, config/metric_set.json).
Here the same schema is loaded from any user-provided JSON file, with a
compact built-in default (written for this project) so the pipelines run out
of the box.  Schema per category:

  {"category": str,
   "metrics": [str, ...],
   "cluster": {cluster_name: [metric, ...]},
   "attributes": {metric: {"unit": str,
                           "seasonal": {"attributes": [...],
                                        "amplitude": {"min","max"},
                                        "period": {"min","max"}},
                           "trend": {"attributes": [...],
                                     "start": {"min","max"},
                                     "amplitude": {"min","max"}},
                           "noise": {"attributes": [...]},
                           "change": {"attributes": [...],
                                      "amplitude": {"min","max"}}}}}
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional


def _attr(
    seasonal: List[str],
    s_amp,
    s_period,
    trend: List[str],
    t_start,
    t_amp,
    noise: List[str],
    change: List[str],
    c_amp,
    unit: str = "minute",
) -> dict:
    return {
        "unit": unit,
        "seasonal": {
            "attributes": seasonal,
            "amplitude": {"min": s_amp[0], "max": s_amp[1]},
            "period": {"min": s_period[0], "max": s_period[1]},
        },
        "trend": {
            "attributes": trend,
            "start": {"min": t_start[0], "max": t_start[1]},
            "amplitude": {"min": t_amp[0], "max": t_amp[1]},
        },
        "noise": {"attributes": noise},
        "change": {
            "attributes": change,
            "amplitude": {"min": c_amp[0], "max": c_amp[1]},
        },
    }


_SPIKES = ["upward spike", "downward spike", "sudden increase", "sudden decrease"]
_ALL_TREND = ["increase", "decrease", "keep steady", "multiple"]
_BOTH_NOISE = ["noisy", "almost no noise"]

DEFAULT_METRIC_SET: List[dict] = [
    {
        "category": "Web Service",
        "metrics": ["CPU Usage", "Memory Usage", "Request Rate", "Error Rate",
                    "Response Time", "Disk IO"],
        "cluster": {
            "Load Metrics": ["CPU Usage", "Request Rate", "Disk IO"],
            "Quality Metrics": ["Error Rate", "Response Time"],
            "Capacity Metrics": ["Memory Usage"],
        },
        "attributes": {
            "CPU Usage": _attr(
                ["sin periodic fluctuation", "no periodic fluctuation"],
                (5.0, 20.0), (24.0, 288.0), _ALL_TREND, (10.0, 80.0),
                (5.0, 30.0), _BOTH_NOISE, _SPIKES + ["continuous upward spike"],
                (5.0, 40.0),
            ),
            "Memory Usage": _attr(
                ["no periodic fluctuation"], (0.0, 0.0), (0.0, 0.0),
                ["increase", "keep steady", "multiple"], (20.0, 70.0),
                (2.0, 20.0), ["almost no noise"],
                ["sudden increase", "sudden decrease", "wide upward spike"],
                (5.0, 25.0),
            ),
            "Request Rate": _attr(
                ["sin periodic fluctuation"], (50.0, 500.0), (60.0, 1440.0),
                _ALL_TREND, (100.0, 2000.0), (50.0, 500.0), _BOTH_NOISE,
                _SPIKES + ["continuous downward spike"], (100.0, 1000.0),
            ),
            "Error Rate": _attr(
                ["no periodic fluctuation"], (0.0, 0.0), (0.0, 0.0),
                ["keep steady"], (0.0, 2.0), (0.0, 1.0), _BOTH_NOISE,
                ["upward spike", "continuous upward spike", "sudden increase",
                 "decrease after upward spike"],
                (1.0, 30.0),
            ),
            "Response Time": _attr(
                ["no periodic fluctuation", "sin periodic fluctuation"],
                (5.0, 50.0), (30.0, 300.0), ["keep steady", "multiple"],
                (10.0, 200.0), (5.0, 50.0), _BOTH_NOISE,
                _SPIKES + ["wide upward spike"], (20.0, 300.0),
            ),
            "Disk IO": _attr(
                ["square periodic fluctuation", "no periodic fluctuation"],
                (10.0, 100.0), (60.0, 600.0), _ALL_TREND, (0.0, 500.0),
                (20.0, 200.0), _BOTH_NOISE, _SPIKES, (50.0, 400.0),
            ),
        },
    },
    {
        "category": "Environment",
        "metrics": ["Temperature", "Humidity", "Air Pressure", "Wind Speed"],
        "cluster": {
            "Thermal Metrics": ["Temperature", "Humidity"],
            "Atmospheric Metrics": ["Air Pressure", "Wind Speed"],
        },
        "attributes": {
            "Temperature": _attr(
                ["sin periodic fluctuation"], (3.0, 15.0), (96.0, 1440.0),
                _ALL_TREND, (-10.0, 35.0), (2.0, 15.0), ["almost no noise"],
                ["sudden increase", "sudden decrease", "wide upward spike",
                 "wide downward spike"],
                (3.0, 12.0), unit="hour",
            ),
            "Humidity": _attr(
                ["sin periodic fluctuation", "no periodic fluctuation"],
                (5.0, 25.0), (96.0, 1440.0), ["keep steady", "multiple"],
                (30.0, 90.0), (5.0, 30.0), _BOTH_NOISE,
                ["sudden increase", "sudden decrease"], (5.0, 30.0),
                unit="hour",
            ),
            "Air Pressure": _attr(
                ["no periodic fluctuation"], (0.0, 0.0), (0.0, 0.0),
                ["keep steady", "multiple"], (980.0, 1040.0), (2.0, 20.0),
                ["almost no noise"], ["slow decline followed by rapid rise",
                                      "rapid decline followed by slow rise"],
                (5.0, 25.0), unit="hour",
            ),
            "Wind Speed": _attr(
                ["no periodic fluctuation"], (0.0, 0.0), (0.0, 0.0),
                _ALL_TREND, (0.0, 15.0), (1.0, 10.0), ["noisy"],
                ["shake", "upward spike", "wide upward spike"], (3.0, 25.0),
                unit="hour",
            ),
        },
    },
    {
        "category": "Finance",
        "metrics": ["Stock Price", "Trading Volume", "Exchange Rate"],
        "cluster": {
            "Price Metrics": ["Stock Price", "Exchange Rate"],
            "Activity Metrics": ["Trading Volume"],
        },
        "attributes": {
            "Stock Price": _attr(
                ["no periodic fluctuation"], (0.0, 0.0), (0.0, 0.0),
                _ALL_TREND, (50.0, 500.0), (5.0, 80.0), _BOTH_NOISE,
                _SPIKES + ["wide upward spike", "wide downward spike"],
                (2.0, 40.0), unit="day",
            ),
            "Trading Volume": _attr(
                ["sin periodic fluctuation", "no periodic fluctuation"],
                (1e4, 1e6), (5.0, 30.0), ["keep steady", "multiple"],
                (1e5, 1e7), (1e4, 1e6), ["noisy"],
                ["upward spike", "continuous upward spike"], (1e5, 5e6),
                unit="day",
            ),
            "Exchange Rate": _attr(
                ["no periodic fluctuation"], (0.0, 0.0), (0.0, 0.0),
                _ALL_TREND, (0.5, 10.0), (0.05, 1.0), ["almost no noise"],
                ["sudden increase", "sudden decrease"], (0.05, 0.8),
                unit="day",
            ),
        },
    },
]


class MetricSet:
    """Loaded metric prior with the reference's flattening semantics."""

    def __init__(self, categories: Optional[List[dict]] = None):
        self.categories = categories if categories is not None else DEFAULT_METRIC_SET
        self.metric_to_attributes: Dict[str, dict] = {}
        for category in self.categories:
            for metric, attrs in category.get("attributes", {}).items():
                self.metric_to_attributes[metric] = attrs

    @classmethod
    def load(cls, path: Optional[str] = None) -> "MetricSet":
        """Load from JSON (reference schema); env var METRIC_SET_PATH
        otherwise.  Without a file, the default is the reference-scale
        generated catalog (~23 categories, ~350 metrics —
        :mod:`chatts_tpu_torch.datagen.metric_catalog`); set
        ``METRIC_SET_SCALE=compact`` to get the small built-in prior.
        """
        path = path or os.environ.get("METRIC_SET_PATH")
        if path and os.path.exists(path):
            with open(path) as f:
                return cls(json.load(f))
        if os.environ.get("METRIC_SET_SCALE") == "compact":
            return cls()
        from chatts_tpu_torch.datagen.metric_catalog import build_metric_set

        return cls(build_metric_set())

    def metric_to_controlled_attributes(self, metric: str) -> Optional[dict]:
        """Reference API (attribute_utils.py:29-30)."""
        return self.metric_to_attributes.get(metric)

    def all_metrics(self) -> List[str]:
        return [m for c in self.categories for m in c.get("metrics", [])]

    def category_of(self, metric: str) -> Optional[str]:
        for c in self.categories:
            if metric in c.get("metrics", []):
                return c["category"]
        return None

    def clusters(self, category: str) -> Dict[str, List[str]]:
        for c in self.categories:
            if c["category"] == category:
                return c.get("cluster", {})
        return {}
