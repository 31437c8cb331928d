"""Percentiles, spreads and windowed rates on hand-made records, and the
drain's wait."""
import threading
import time

import pytest

from port_bench import harness, stats


def test_percentile():
    vals = list(range(1, 101))  # 1 .. 100
    assert stats.percentile(vals, 50) == pytest.approx(50.5)
    assert stats.percentile(vals, 80) == pytest.approx(80.2)
    assert stats.percentile(vals, 90) == pytest.approx(90.1)
    assert stats.percentile([], 90) is None


def test_round_window_and_rate():
    ends = [0.5, 1.0, 1.5, 2.0, 2.5, 3.0]
    assert stats.round_window(ends, 0.8, 2.7) == (1.0, 2.5)
    assert stats.round_window(ends, 2.6, 2.9) is None
    # tokens delivered in rounds ending in (1.0, 2.5]: 30 + 40 + 50
    puts = [(0.9, 10), (1.0, 20), (1.4, 30), (1.9, 40), (2.5, 50), (2.6, 60)]
    lo, hi = stats.round_window(ends, 0.8, 2.7)
    assert stats.count_in(puts, lo, hi) / (hi - lo) == pytest.approx(120 / 1.5)


def test_merge_intervals():
    assert stats.merge_intervals([(3, 4), (0, 1), (0.5, 2), (2, 2.5)]) == [(0, 2.5), (3, 4)]


def test_drain_waits_out_the_profiler_stall():
    class Rec:
        done = None

    r, stalled = Rec(), [0.0]

    def finish():
        time.sleep(0.3)
        stalled[0] = 1.0  # the engine's thread was held for a second
        time.sleep(0.3)
        r.done = time.perf_counter()

    t = threading.Thread(target=finish)
    t.start()
    harness.drain([r], 0.4, lambda: stalled[0])
    t.join()
    assert r.done is not None
    r2 = Rec()
    t0 = time.perf_counter()
    harness.drain([r2], 0.2)
    assert r2.done is None and time.perf_counter() - t0 < 1.0
