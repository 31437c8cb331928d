"""The port's datagen core (``chatts_tpu_torch.datagen``: config, trends, the
19 change injectors, the generator, the MTS local template QA) against the
JAX package's, on the same seeds. Both draw from one
``numpy.random.Generator`` in the same order, so every series, attribute
pool and text must be equal: the tolerance is exact (``np.array_equal``,
``==``, and the same type at every leaf). The second half holds the port to
the assertions of ``tests/test_datagen.py``."""
import dataclasses
import re

import numpy as np
import pytest

from chatts_tpu.datagen import changes as jchanges
from chatts_tpu.datagen import config as jconfig
from chatts_tpu.datagen import generator as jgenerator
from chatts_tpu.datagen import trends as jtrends
from chatts_tpu.datagen.align import mts_local_template_qa as jmts
from chatts_tpu_torch.datagen import changes as changes_lib
from chatts_tpu_torch.datagen import config as config_lib
from chatts_tpu_torch.datagen import trends as trends_lib
from chatts_tpu_torch.datagen.align import mts_local_template_qa as mts
from chatts_tpu_torch.datagen.config import DatagenConfig
from chatts_tpu_torch.datagen.generator import (
    ALL_ATTRIBUTE_SET,
    TimeSeriesGenerator,
    attribute_to_caption,
    attribute_to_text,
    prompt_to_inference,
)

SEEDS = range(8)
LENGTHS = (16, 64, 256, 1024)


def assert_same(got, want, path="$"):
    """Exact equality with the same type at every leaf (an int where JAX's
    has an int, a float where it has a float)."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        assert np.array_equal(got, want), path
        return
    assert type(got) is type(want), f"{path}: {type(got)} != {type(want)}"
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    else:
        assert got == want, f"{path}: {got!r} != {want!r}"


def _generate(gen, seq_len):
    """(series, pool) or the exception's type, with the generator's state
    after the call, so a failed draw is held to the same failure."""
    pool = gen.generate_random_attributes(seq_len=seq_len)
    try:
        y, pool = gen.generate(pool, seq_len)
        out = (y, pool)
    except (ValueError, IndexError) as e:
        out = type(e).__name__
    return out, gen.rng.bit_generator.state


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_generator_equal_jax(seed):
    for seq_len in LENGTHS:
        got = _generate(TimeSeriesGenerator(seed=seed), seq_len)
        want = _generate(jgenerator.TimeSeriesGenerator(seed=seed), seq_len)
        assert_same(got, want, f"seed {seed} len {seq_len}")


@pytest.mark.parametrize("seed", (0, 5))
def test_torch_generator_draw_sequence_equal_jax(seed):
    """Ten samples from one generator: each draw's order carries over to the
    next sample."""
    gen, jgen = TimeSeriesGenerator(seed=seed), jgenerator.TimeSeriesGenerator(seed=seed)
    for i in range(10):
        seq_len = int(gen.rng.integers(16, 1025))
        assert seq_len == int(jgen.rng.integers(16, 1025))
        assert_same(_generate(gen, seq_len), _generate(jgen, seq_len), f"sample {i}")


@pytest.mark.parametrize("ctype", sorted(jchanges.supported_change_types()))
def test_torch_change_type_equal_jax(ctype):
    assert changes_lib.supported_change_types() == jchanges.supported_change_types()
    for seed in range(4):
        for seq_len, amplitude in ((512, None), (96, 3.0)):
            spec = [{"type": ctype, "amplitude": amplitude}]
            got = changes_lib.apply_local_changes(
                np.random.default_rng(seed), spec, overall_amplitude=10.0, seq_len=seq_len)
            want = jchanges.apply_local_changes(
                np.random.default_rng(seed), spec, overall_amplitude=10.0, seq_len=seq_len)
            assert_same(got, want, f"{ctype} seed {seed} len {seq_len}")


def test_torch_easing_and_spike_primitives_equal_jax():
    for seed in range(3):
        for length in (1, 4, 40):
            assert_same(changes_lib.easing_change(np.random.default_rng(seed), length, 10.0),
                        jchanges.easing_change(np.random.default_rng(seed), length, 10.0))
        assert_same(changes_lib.spike_shape(np.random.default_rng(seed), 5.0, 12),
                    jchanges.spike_shape(np.random.default_rng(seed), 5.0, 12))


def test_torch_trends_equal_jax():
    for seed in range(6):
        for seq_len in (16, 64, 256, 1024):
            rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
            points = trends_lib.generate_random_points(rng, seq_len)
            assert_same(points, jtrends.generate_random_points(jrng, seq_len))
            curve = trends_lib.generate_trend_curve(rng, seq_len, points[0])
            assert_same(curve, jtrends.generate_trend_curve(jrng, seq_len, points[0]))
            assert trends_lib.generate_trend_prompt(points[0]) == \
                jtrends.generate_trend_prompt(points[0])
            assert_same(trends_lib.generate_trend_list(points[0], seq_len),
                        jtrends.generate_trend_list(points[0], seq_len))


def test_torch_text_and_caption_equal_jax():
    for seed in range(6):
        for seq_len in (64, 256):
            gen, jgen = TimeSeriesGenerator(seed=seed), jgenerator.TimeSeriesGenerator(seed=seed)
            pool = gen.generate_random_attributes(change_positions=[(None, None)] * 2,
                                                  seq_len=seq_len)
            jpool = jgen.generate_random_attributes(change_positions=[(None, None)] * 2,
                                                    seq_len=seq_len)
            y, pool = gen.generate(pool, seq_len)
            jy, jpool = jgen.generate(jpool, seq_len)
            for values in (True, False):
                assert attribute_to_text(y, pool, generate_values=values) == \
                    jgenerator.attribute_to_text(jy, jpool, generate_values=values)
            assert attribute_to_caption(y, pool, rng=np.random.default_rng(seed)) == \
                jgenerator.attribute_to_caption(jy, jpool, rng=np.random.default_rng(seed))
            series = [y[:8].reshape(-1, 1)]
            assert prompt_to_inference(series, "x <ts><ts/> y") == \
                jgenerator.prompt_to_inference(series, "x <ts><ts/> y")


def test_torch_controlled_attributes_equal_jax():
    attribute_set = {
        "seasonal": {"attributes": ["sin periodic fluctuation"],
                     "amplitude": {"min": 5.0, "max": 10.0}, "period": {"min": 20, "max": 40}},
        "trend": {"attributes": ["increase"], "start": {"min": 100.0, "max": 200.0},
                  "amplitude": {"min": 10.0, "max": 20.0}},
        "change": {"attributes": ["upward spike"], "amplitude": {"min": 3.0, "max": 5.0}},
        "noise": {"attributes": ["almost no noise"]},
    }
    for seed in range(4):
        gen, jgen = TimeSeriesGenerator(seed=seed), jgenerator.TimeSeriesGenerator(seed=seed)
        desc = gen.generate_controlled_attributes(attribute_set, change_positions=[(None, None)],
                                                  seq_len=256)
        jdesc = jgen.generate_controlled_attributes(attribute_set,
                                                    change_positions=[(None, None)], seq_len=256)
        assert_same(desc, jdesc)
        assert_same(gen.generate(desc, 256), jgen.generate(jdesc, 256))


def test_torch_datagen_config_equal_jax(tmp_path):
    raw = {"enable_multiple_trend": False, "num_cpus": 3, "encoding_method": "sp",
           "unknown_key": 1}
    assert dataclasses.asdict(DatagenConfig.from_dict(raw)) == \
        dataclasses.asdict(jconfig.DatagenConfig.from_dict(raw))
    assert dataclasses.asdict(config_lib.DEFAULT) == dataclasses.asdict(jconfig.DEFAULT)
    pytest.importorskip("yaml")
    path = tmp_path / "datagen_config.yaml"
    path.write_text("enable_multiple_noise: false\ndryrun: true\nother: 2\n")
    assert dataclasses.asdict(DatagenConfig.from_yaml(str(path))) == \
        dataclasses.asdict(jconfig.DatagenConfig.from_yaml(str(path)))


@pytest.mark.parametrize("seq_len", (None, 128))
def test_torch_mts_local_template_qa_equal_jax(seq_len):
    assert mts.LOCAL_CONFIG == jmts.LOCAL_CONFIG
    got = list(mts.generate_samples(3, seed=2, seq_len=seq_len))
    want = list(jmts.generate_samples(3, seed=2, seq_len=seq_len))
    assert_same(got, want)


# ---------------------------------------------------------------------------
# tests/test_datagen.py's assertions, on the port
# ---------------------------------------------------------------------------

def make_gen(seed=0, **kw):
    return TimeSeriesGenerator(DatagenConfig(**kw), seed=seed)


def test_torch_seeded_determinism():
    for seed in (0, 7):
        g1, g2 = make_gen(seed), make_gen(seed)
        a1 = g1.generate_random_attributes(seq_len=256)
        a2 = g2.generate_random_attributes(seq_len=256)
        assert a1 == a2
        y1, p1 = g1.generate(a1, 256)
        y2, p2 = g2.generate(a2, 256)
        np.testing.assert_array_equal(y1, y2)
        assert p1["statistics"] == p2["statistics"]


def test_torch_all_19_change_types_apply():
    assert len(changes_lib.supported_change_types()) == 19
    assert set(changes_lib.supported_change_types()) == set(ALL_ATTRIBUTE_SET["change"])
    for i, ctype in enumerate(changes_lib.supported_change_types()):
        rng = np.random.default_rng(i)
        delta, recs = changes_lib.apply_local_changes(
            rng, [{"type": ctype}], overall_amplitude=10.0, seq_len=512)
        assert len(recs) == 1, ctype
        rec = recs[0]
        assert rec["type"] == ctype
        assert 0 <= rec["position_start"] < rec["position_end"] < 512
        assert rec["amplitude"] > 0
        assert rec["detail"]
        assert np.abs(delta).max() > 0


def test_torch_change_never_exceeds_seq_len_and_no_overlap():
    for seed in range(30):
        rng = np.random.default_rng(seed)
        types = list(np.random.default_rng(seed).choice(
            changes_lib.supported_change_types(), size=3))
        _, recs = changes_lib.apply_local_changes(
            rng, [{"type": t} for t in types], overall_amplitude=5.0, seq_len=128)
        for rec in recs:
            assert rec["position_end"] < 128
    _, recs = changes_lib.apply_local_changes(
        np.random.default_rng(3),
        [{"type": "upward spike"}, {"type": "downward spike"}, {"type": "shake"}],
        overall_amplitude=5.0, seq_len=512)
    recs = sorted(recs, key=lambda r: r["position_start"])
    for a, b in zip(recs, recs[1:]):
        assert a["position_end"] <= b["position_start"]


def test_torch_short_sequence_degradation():
    pool = make_gen(1).generate_random_attributes(seq_len=16)
    assert pool["seasonal"]["type"] == "no periodic fluctuation"
    assert pool["frequency"]["type"] == "no periodicity"
    assert pool["noise"]["type"] == "almost no noise"


def test_torch_generate_backfills_labels():
    g = make_gen(2)
    pool = g.generate_random_attributes(seq_len=256)
    y, pool = g.generate(pool, 256)
    assert len(y) == 256
    st = pool["statistics"]
    assert st["max"] == round(float(np.max(y)), 2)
    assert st["min_pos"] == int(np.argmin(y))
    assert "trend_list" in pool["trend"]
    assert "detail" in pool["noise"]
    for c in pool["local"]:
        assert not re.search(r"<\|\d+\|>", c["detail"])


def test_torch_attribute_to_text_and_caption():
    g = make_gen(5)
    pool = g.generate_random_attributes(change_positions=[(None, None)], seq_len=128)
    y, pool = g.generate(pool, 128)
    text = attribute_to_text(y, pool)
    assert "The length of the time series is 128." in text
    assert "Specific data details" in text
    assert "Specific data details" not in attribute_to_text(y, pool, generate_values=False)
    assert "In terms of the trend and changes" in attribute_to_caption(
        y, pool, rng=np.random.default_rng(0))


def test_torch_multiple_and_disabled_trend():
    pool = {"seasonal": {"type": "no periodic fluctuation"}, "trend": {"type": "multiple"},
            "local": [], "frequency": {"type": "no periodicity"},
            "noise": {"type": "almost no noise"}, "seq_len": 512}
    y, pool = make_gen(6).generate(pool, 512)
    assert len(pool["trend"]["trend_list"]) > 1
    for trend, a, b in pool["trend"]["trend_list"]:
        assert trend in ("increase", "decrease", "steady")
        assert 0 <= a < b <= 511
    pool = {"seasonal": {"type": "sin periodic fluctuation"}, "trend": {"type": "multiple"},
            "local": [], "frequency": {"type": "low frequency"},
            "noise": {"type": "almost no noise"}, "seq_len": 128}
    y, pool = make_gen(7, enable_multiple_trend=False).generate(pool, 128)
    assert pool["trend"]["type"] in ("increase", "decrease", "keep steady")
    assert pool["seasonal"]["type"] == "periodic fluctuation"


def test_torch_trend_utils_and_waves():
    rng = np.random.default_rng(8)
    points, _ = trends_lib.generate_random_points(rng, 256)
    assert points[0][0] == 0 and points[-1][0] == 255
    xs = [p[0] for p in points]
    assert xs == sorted(xs)
    _, curve, _ = trends_lib.generate_trend_curve(rng, 256, points)
    assert len(curve) == 256
    assert "From point 0" in trends_lib.generate_trend_prompt(points)
    assert trends_lib.generate_trend_list(points, 256)[-1][2] == 255
    g = make_gen(9)
    for wave in ("sin", "square", "triangle"):
        y = g.seasonal_wave(32.0, [5.0], [0, 256], 256, wave)
        assert len(y) == 256
        assert abs(float(np.mean(y))) < 1.0
        assert np.max(y) - np.min(y) > 1.0
    assert prompt_to_inference([[[1.23456, 2.0]]], "a <ts><ts/> b") == \
        "a <ts>[[1.2346, 2.0]]<ts/> b"


def test_torch_generation_sweep_lengths():
    for seed in range(8):
        for seq_len in (5, 64, 256, 1024):
            g = make_gen(seed * 100 + seq_len)
            pool = g.generate_random_attributes(seq_len=seq_len)
            y, pool = g.generate(pool, seq_len)
            assert np.all(np.isfinite(y))
            for c in pool["local"]:
                assert c["position_end"] < seq_len

