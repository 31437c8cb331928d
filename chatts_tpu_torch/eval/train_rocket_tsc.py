"""Train the ROCKET change-type classifier on synthetic 64-pt windows.

The port's copy of ``chatts_tpu/eval/train_rocket_tsc.py``: the same numpy code, so a seed
gives the same bits in both packages.

Behavioral re-implementation of the reference trainer
(reference: evaluation/train_rocket_tsc.py:71-134): the 19 classes are the
sorted local-change type list; windows are synthesized by injecting one
change into a 64-pt baseline; the fitted classifier persists to a single
file consumed by the ReAct agent's classification tools.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from chatts_tpu_torch.datagen import changes as changes_lib
from chatts_tpu_torch.eval.ts_tools import RocketClassifier

WINDOW = 64
change_type_list: List[str] = sorted(changes_lib.supported_change_types())


def synthesize_window(
    rng: np.random.Generator, change_type: str
) -> np.ndarray:
    """One 64-pt window containing the given change near the center."""
    amplitude = rng.uniform(3.0, 10.0)
    y = rng.normal(0, 0.05 * amplitude, WINDOW)
    entry = changes_lib.CHANGE_REGISTRY[change_type]
    min_len = entry["min_length"]
    start = int(rng.integers(2, max(3, WINDOW - min_len - 16)))
    entry["fn"](rng, y, WINDOW, amplitude, start, None)
    return y


def build_dataset(
    samples_per_class: int = 50, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    X, y = [], []
    for ctype in change_type_list:
        made = 0
        while made < samples_per_class:
            try:
                X.append(synthesize_window(rng, ctype))
            except changes_lib.ChangePlacementError:
                continue
            # String labels so the agent's classification tools report the
            # change-type NAME (reference: react_agent classification output
            # "The classification result is <type>").
            y.append(ctype)
            made += 1
    return np.stack(X), np.asarray(y)


def train(
    output_path: str = "result/rocket.npz",
    samples_per_class: int = 50,
    num_kernels: int = 1000,
    seed: int = 0,
) -> float:
    """Train + persist; returns held-out accuracy."""
    X, y = build_dataset(samples_per_class, seed)
    X_test, y_test = build_dataset(max(samples_per_class // 5, 5), seed + 1)
    clf = RocketClassifier(num_kernels=num_kernels, seed=seed)
    clf.fit(X, y)
    acc = clf.score(X_test, y_test)
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    clf.save(output_path)
    return acc


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--output", default="result/rocket.npz")
    p.add_argument("--samples-per-class", type=int, default=50)
    p.add_argument("--num-kernels", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    acc = train(args.output, args.samples_per_class, args.num_kernels, args.seed)
    print(f"held-out accuracy over {len(change_type_list)} classes: {acc:.3f}")
