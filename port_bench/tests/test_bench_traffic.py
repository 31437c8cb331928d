"""The traffic generator: deterministic by seed, the same set of sizes and
gaps for every seed, the distributions the mix files state."""
import json
import os

import numpy as np
import pytest

from port_bench.traffic import Traffic

HERE = os.path.dirname(os.path.abspath(__file__))
MIXES = os.path.join(HERE, "..", "traffic")


def mix(name):
    with open(os.path.join(MIXES, name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["chat", "mts_long"])
def test_same_seed_same_requests(name):
    a, b = Traffic(mix(name), 2**31 + 5), Traffic(mix(name), 2**31 + 5)
    for i in (0, 7, 1023, 1030):
        sa, sb = a.spec(i), b.spec(i)
        assert sa.prompt == sb.prompt and sa.max_tokens == sb.max_tokens
        assert all(np.array_equal(x, y) for x, y in zip(sa.series, sb.series))


@pytest.mark.parametrize("name", ["chat", "mts_long"])
def test_seeds_share_the_set_of_sizes(name):
    a, b = Traffic(mix(name), 1), Traffic(mix(name), 2**33 + 1)
    shapes = [[x.shape(i) for i in range(x.pool)] for x in (a, b)]
    assert shapes[0] != shapes[1]  # another order and pairing
    for k in (0, 2):  # words and max_tokens: the same multiset
        assert sorted(s[k] for s in shapes[0]) == sorted(s[k] for s in shapes[1])
    lens = [sorted(n for s in sh for n in s[1]) for sh in shapes]
    assert abs(np.mean(lens[0]) - np.mean(lens[1])) < 0.05 * np.mean(lens[0])


def test_distributions_follow_the_mix():
    m = mix("chat")
    t = Traffic(m, 9)
    shapes = [t.shape(i) for i in range(t.pool)]
    words = np.array([s[0] for s in shapes])
    toks = np.array([s[2] for s in shapes])
    assert words.min() >= 150 and words.max() <= 600
    assert toks.min() >= 32 and toks.max() <= 512
    # log-uniform: the median is the geometric mean of the ends
    assert abs(np.median(toks) - np.sqrt(32 * 512)) < 3
    counts = np.bincount([len(s[1]) for s in shapes])[1:]
    assert list(counts) == [21, 22, 21]  # (i + 0.5) / 64 in thirds
    lens = np.array([n for s in shapes for n in s[1]])
    assert lens.min() >= 64 and lens.max() <= 1024


def test_open_loop_arrivals_have_the_rate():
    m = dict(mix("mts_long"), rate=5.0, ramp_s=10)
    due = Traffic(m, 4).arrivals(40.0)
    assert np.all(np.diff(due) > 0) and due[-1] < 50.0
    assert abs(len(due) - 250) <= 3
    other = Traffic(m, 5).arrivals(40.0)
    assert not np.array_equal(due[:20], other[:20])
