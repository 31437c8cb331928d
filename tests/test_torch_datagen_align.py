"""The port's encoding helpers, metric prior and six alignment pipelines
(``chatts_tpu_torch.core.encoding``, ``datagen.metric_catalog``,
``datagen.metric_set``, ``datagen.align.*``) against the JAX package's, on
the same seeds. Both draw from one ``numpy.random.Generator`` in the same
order, so rows, labels and written files must be equal: the tolerance is
exact (``assert_same``, and files byte for byte). The LLM stages run with the
dryrun engine and with a scripted LLM that is a pure function of its prompt,
so the thread pool's completion order cannot change an answer. The second
half holds the port to the assertions of ``tests/test_encoding.py``,
``tests/test_metric_catalog.py`` and ``tests/test_align_pipelines.py``."""
import json
import runpy
import sys

import numpy as np
import pytest

from chatts_tpu.core import encoding as jencoding
from chatts_tpu.datagen import metric_catalog as jcatalog
from chatts_tpu.datagen import metric_set as jmetric_set
from chatts_tpu.datagen.align import mts_llm_qa as jmts_llm
from chatts_tpu.datagen.align import mts_local_template_qa as jmts_local
from chatts_tpu.datagen.align import mts_shape_template_qa as jmts_shape
from chatts_tpu.datagen.align import uts_llm_qa as juts_llm
from chatts_tpu.datagen.align import uts_template_qa as juts
from chatts_tpu.datagen.generator import TimeSeriesGenerator as JTimeSeriesGenerator
from chatts_tpu.utils.llm_client import LLMClient as JLLMClient
from chatts_tpu_torch.core import encoding
from chatts_tpu_torch.datagen.align import (mts_local_template_qa, mts_shape_template_qa,
                                            uts_template_qa)
from chatts_tpu_torch.datagen.align import mts_llm_qa, uts_llm_qa
from chatts_tpu_torch.datagen.generator import ALL_ATTRIBUTE_SET, TimeSeriesGenerator
from chatts_tpu_torch.datagen.metric_catalog import build_metric_set
from chatts_tpu_torch.datagen.metric_set import MetricSet
from chatts_tpu_torch.utils.llm_client import LLMClient
from tests.test_torch_datagen import assert_same


def explain(prompt: str) -> str:
    """A scripted LLM answer that depends on the prompt alone."""
    return f"Explained in {len(prompt)} characters: {prompt[-40:]!r}."


def clients(kind):
    """The same LLM for both packages: (port client, JAX client)."""
    if kind == "dryrun":
        return tuple(cls(engine="dryrun", dryrun_sleep_s=0.0,
                         dryrun_output="This is a test answer.")
                     for cls in (LLMClient, JLLMClient))
    return (LLMClient(engine="openai", openai_client=explain),
            JLLMClient(engine="openai", openai_client=explain))


def assert_same_files(port_dir, jax_dir):
    names = sorted(p.relative_to(jax_dir) for p in jax_dir.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(port_dir) for p in port_dir.rglob("*")
                           if p.is_file())
    assert names
    for name in names:
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes(), name


# ---------------------------------------------------------------------------
# Encoding helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ("sp", "minmax_scale", "no"))
@pytest.mark.parametrize("seed", range(3))
def test_torch_encoding_helpers_equal_jax(seed, method):
    rng = np.random.default_rng(seed)
    series = [rng.normal(0, 10.0 ** seed, n).cumsum() for n in (5, 64, 33)]
    prompt = "a <ts><ts/> b <ts><ts/> c <ts><ts/> d"
    if method == "no":
        # A 1-D series cannot be padded as (1, L, 1): both packages refuse.
        for mod in (encoding, jencoding):
            with pytest.raises(ValueError):
                mod.eval_prompt_to_encoding(prompt, series, method)
    else:
        assert_same(encoding.eval_prompt_to_encoding(prompt, series, method),
                    jencoding.eval_prompt_to_encoding(prompt, series, method))
    rows = [s[:, None] for s in series]
    assert encoding.timeseries_prompt(prompt, rows) == jencoding.timeseries_prompt(prompt, rows)
    enc, _, meta = encoding.sp_encoding(series[1])
    assert_same(encoding.sp_decode(enc, meta), jencoding.sp_decode(enc, meta))
    for n in (1, 16, 17, 1023, 4096):
        for patch in (8, 16):
            assert (encoding.num_patches_from_encoded(n, patch)
                    == jencoding.num_patches_from_encoded(n, patch))


def test_torch_encoding_refusals_equal_jax():
    for mod in (encoding, jencoding):
        with pytest.raises(ValueError):
            mod.eval_prompt_to_encoding("<ts><ts/>", [np.ones(3), np.ones(3)], "sp")
        with pytest.raises(ValueError):
            mod.timeseries_prompt("<ts><ts/> <ts><ts/>", [[[1.0]]])


# tests/test_encoding.py, on the port

def test_torch_sp_encoding_shape_and_interleave():
    enc, prompt, _ = encoding.sp_encoding(np.array([1.0, 2.0, 3.0, 4.0]))
    assert enc.shape == (8, 1)
    assert np.all(enc.reshape(-1, 2)[:, 1] == 1.0)
    assert "[Value Offset:" in prompt and prompt.endswith("<ts><ts/>")


def test_torch_sp_encoding_scale():
    enc, _, meta = encoding.sp_encoding(np.array([0.0, 1.0, 2.0]))
    assert meta["scale_factor"] == 1.0
    np.testing.assert_allclose(enc.reshape(-1, 2)[:, 0], [-1.0, 0.0, 1.0])
    ts = np.array([0.0, 0.0, 30.0])
    enc, _, meta = encoding.sp_encoding(ts)
    assert np.max(np.abs(enc.reshape(-1, 2)[:, 0])) == pytest.approx(3.0)
    assert meta["scale_factor"] == pytest.approx(np.max(np.abs(ts - ts.mean())) / 3.0)


@pytest.mark.parametrize("length", [5, 64, 257, 1024, 4096])
def test_torch_sp_round_trip(length):
    ts = np.random.default_rng(length).normal(0, 1000.0, length).cumsum()
    enc, _, meta = encoding.sp_encoding(ts)
    np.testing.assert_allclose(encoding.sp_decode(enc, meta), ts, rtol=1e-9, atol=1e-6)


def test_torch_minmax_no_encoding_and_dispatch():
    ts = np.arange(10.0)
    enc, prompt, _ = encoding.minmax_scale_encoding(ts)
    assert enc.shape == (10, 1) and prompt.startswith("[Offset:")
    enc2, prompt2, meta2 = encoding.no_encoding(ts)
    np.testing.assert_array_equal(enc2, ts)
    assert prompt2 == "<ts><ts/>" and meta2 == {}
    for method in ("sp", "minmax_scale", "no"):
        encoding.timeseries_encoding(ts[:4], method)
    with pytest.raises(NotImplementedError):
        encoding.timeseries_encoding(ts, "bogus")


def test_torch_eval_prompt_to_encoding_pads_batch():
    out_prompt, batch = encoding.eval_prompt_to_encoding(
        "a <ts><ts/> b <ts><ts/> c", [np.arange(4.0), np.arange(8.0) * 100], "sp")
    assert batch.shape == (2, 16, 1)
    assert np.all(batch[0, 8:] == 0)
    assert out_prompt.count("[Value Offset:") == 2
    assert out_prompt.count("<ts><ts/>") == 2


@pytest.mark.parametrize(
    "length,patch,expected",
    [(64, 16, 4), (65, 16, 5), (5, 16, 1), (1024, 16, 64), (16, 16, 1)],
)
def test_torch_patch_count_contract(length, patch, expected):
    assert encoding.num_patches(length, patch) == expected
    assert encoding.num_patches_from_encoded(2 * length, patch) == expected


def test_torch_timeseries_to_list_and_prompt():
    assert encoding.timeseries_to_list(np.array([1.23456789, 2.0])) == [1.234568, 2.0]
    assert (encoding.timeseries_to_list([[1.23456789], [2.987654321]])
            == [[1.234568], [2.987654]])
    out = encoding.timeseries_prompt("x <ts><ts/> y", [[[1.23456, 2.0]]])
    assert "<ts>[[1.235, 2.0]]<ts/>" in out


# ---------------------------------------------------------------------------
# Metric prior
# ---------------------------------------------------------------------------

def test_torch_metric_catalog_equal_jax():
    assert_same(build_metric_set(), jcatalog.build_metric_set())


def test_torch_metric_catalog_export_equal_jax(tmp_path, monkeypatch, capsys):
    from chatts_tpu_torch.datagen import metric_catalog

    for name, module in (("port.json", metric_catalog), ("jax.json", jcatalog)):
        monkeypatch.setattr(sys, "argv", [module.__file__, str(tmp_path / name)])
        runpy.run_path(module.__file__, run_name="__main__")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    port_line, jax_line = capsys.readouterr().out.splitlines()
    assert port_line == jax_line and port_line.startswith("32 categories")


@pytest.mark.parametrize("mode", ("catalog", "compact", "path"))
def test_torch_metric_set_load_equal_jax(mode, monkeypatch, tmp_path):
    monkeypatch.delenv("METRIC_SET_PATH", raising=False)
    monkeypatch.delenv("METRIC_SET_SCALE", raising=False)
    if mode == "compact":
        monkeypatch.setenv("METRIC_SET_SCALE", "compact")
    elif mode == "path":
        path = tmp_path / "ms.json"
        path.write_text(json.dumps(jcatalog.build_metric_set()[3:5]))
        monkeypatch.setenv("METRIC_SET_PATH", str(path))
    got, want = MetricSet.load(), jmetric_set.MetricSet.load()
    assert_same(got.categories, want.categories)
    assert_same(got.metric_to_attributes, want.metric_to_attributes)
    assert got.all_metrics() == want.all_metrics()
    assert len(got.categories) == {"catalog": 32, "compact": 3, "path": 2}[mode]


# tests/test_metric_catalog.py, on the port

def test_torch_catalog_scale_and_schema():
    cats = build_metric_set()
    assert len(cats) >= 30
    assert len([m for c in cats for m in c["metrics"]]) >= 450
    overall = ALL_ATTRIBUTE_SET["overall_attribute"]
    valid = {"change": set(ALL_ATTRIBUTE_SET["change"]), "seasonal": set(overall["seasonal"]),
             "trend": set(overall["trend"]), "noise": set(overall["noise"])}
    for c in cats:
        assert len(c["metrics"]) == len(set(c["metrics"]))
        assert c["cluster"], c["category"]
        clustered = [m for members in c["cluster"].values() for m in members]
        assert set(clustered) == set(c["metrics"])
        for m in c["metrics"]:
            a = c["attributes"][m]
            for section, names in valid.items():
                assert set(a[section]["attributes"]) <= names, m
            for section, key in (("seasonal", "amplitude"), ("trend", "start"),
                                 ("trend", "amplitude"), ("change", "amplitude")):
                assert a[section][key]["min"] <= a[section][key]["max"], (m, section, key)


def test_torch_load_defaults_to_full_catalog(monkeypatch):
    monkeypatch.delenv("METRIC_SET_PATH", raising=False)
    monkeypatch.delenv("METRIC_SET_SCALE", raising=False)
    ms = MetricSet.load()
    assert len(ms.categories) >= 20
    assert "CPU Usage" in ms.all_metrics()
    assert ms.category_of("Temperature") == "Environment"
    monkeypatch.setenv("METRIC_SET_SCALE", "compact")
    assert len(MetricSet.load().categories) == 3


def test_torch_controlled_datagen_across_ten_categories():
    ms = MetricSet.load()
    gen = TimeSeriesGenerator(seed=7)
    covered = set()
    for c in ms.categories[:12]:
        metric = c["metrics"][0]
        desc = gen.generate_controlled_attributes(
            ms.metric_to_controlled_attributes(metric), [(None, None)], 256)
        y, _ = gen.generate(desc, 256)
        assert len(y) == 256 and np.all(np.isfinite(y)), metric
        covered.add(c["category"])
    assert len(covered) >= 10


def test_torch_mts_llm_pipeline_spans_ten_categories():
    client = LLMClient(engine="dryrun", dryrun_sleep_s=0.0,
                       dryrun_output="a scripted explanation")
    ms = MetricSet.load()
    g = mts_llm_qa.MTSLocalLLMQAGenerator(metric_set=ms, seed=3, seq_len=128)
    rows, evol_labels, _ = g.generate_dataset(40, client)
    assert rows and evol_labels
    categories = set()
    for _ in range(30):
        try:
            item, _, _ = g.generate_prompt_data()
        except (ValueError, IndexError):
            continue
        categories.update(ms.category_of(m) for m in item["metrics"] if ms.category_of(m))
    assert len(categories) >= 10, sorted(categories)


def test_torch_metric_set_default_and_lookup():
    ms = MetricSet.load()
    assert ms.metric_to_controlled_attributes("CPU Usage") is not None
    assert ms.metric_to_controlled_attributes("nonexistent") is None
    assert ms.category_of("Temperature") == "Environment"
    clusters = ms.clusters("Web Service")
    assert "Load Metrics" in clusters
    for metrics in clusters.values():
        assert set(metrics) <= set(ms.all_metrics())
    gen = TimeSeriesGenerator(seed=0)
    desc = gen.generate_controlled_attributes(
        ms.metric_to_controlled_attributes("CPU Usage"), [(None, None)], 256)
    assert len(gen.generate(desc, 256)[0]) == 256


def test_torch_metric_set_loads_reference_format(tmp_path):
    custom = [{
        "category": "Test", "metrics": ["M1"], "cluster": {"C": ["M1"]},
        "attributes": {"M1": {
            "unit": "s",
            "seasonal": {"attributes": ["no periodic fluctuation"],
                         "amplitude": {"min": 0, "max": 0}, "period": {"min": 0, "max": 0}},
            "trend": {"attributes": ["increase"], "start": {"min": 0, "max": 1},
                      "amplitude": {"min": 1, "max": 2}},
            "noise": {"attributes": ["almost no noise"]},
            "change": {"attributes": ["upward spike"], "amplitude": {"min": 1, "max": 2}},
        }},
    }]
    path = tmp_path / "ms.json"
    path.write_text(json.dumps(custom))
    ms = MetricSet.load(str(path))
    assert ms.all_metrics() == ["M1"]
    assert ms.metric_to_controlled_attributes("M1")["unit"] == "s"


# ---------------------------------------------------------------------------
# Template pipelines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq_len", (128, None))
@pytest.mark.parametrize("module,jmodule", [
    (uts_template_qa, juts), (mts_shape_template_qa, jmts_shape),
    (mts_local_template_qa, jmts_local)], ids=("uts", "mts_shape", "mts_local"))
def test_torch_template_pipeline_equal_jax(module, jmodule, seq_len):
    for seed in (0, 1):
        assert_same(list(module.generate_samples(6, seed, seq_len, "sp")),
                    list(jmodule.generate_samples(6, seed, seq_len, "sp")))


@pytest.mark.parametrize("module,jmodule", [
    (uts_template_qa, juts), (mts_shape_template_qa, jmts_shape)],
    ids=("uts", "mts_shape"))
def test_torch_template_main_writes_the_same_file(module, jmodule, tmp_path):
    assert (module.main(str(tmp_path / "port" / "d.jsonl"), 8, 3)
            == jmodule.main(str(tmp_path / "jax" / "d.jsonl"), 8, 3) == 8)
    assert_same_files(tmp_path / "port", tmp_path / "jax")


def test_torch_sample_seq_len_equal_jax():
    for extreme in (False, True):
        gen, jgen = TimeSeriesGenerator(seed=4), JTimeSeriesGenerator(seed=4)
        got = [uts_template_qa.sample_seq_len(gen, extreme) for _ in range(200)]
        assert got == [juts.sample_seq_len(jgen, extreme) for _ in range(200)]
        assert gen.rng.bit_generator.state == jgen.rng.bit_generator.state


# tests/test_align_pipelines.py, on the port

def test_torch_uts_template_rows(tmp_path):
    out = tmp_path / "uts.jsonl"
    assert uts_template_qa.main(str(out), num_data=12, seed=0, seq_len=128) == 12
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) == 12
    for row in rows:
        assert set(row) == {"input", "output", "timeseries"}
        assert "<ts><ts/>" in row["input"] and isinstance(row["timeseries"], list)
    assert any("JSON format" in r["input"] for r in rows)
    assert any("periodicity, trend, local characteristics" in r["input"] for r in rows)


def test_torch_uts_template_json_answer_and_determinism():
    samples = list(uts_template_qa.generate_samples(20, seed=1, seq_len=128))
    parsed = json.loads([s for s in samples if "JSON format" in s["input"]][0]["output"])
    assert "trend" in parsed and "seasonal" in parsed
    assert "statistics" not in parsed and "overall_amplitude" not in parsed
    assert (list(uts_template_qa.generate_samples(6, seed=7, seq_len=64))
            == list(uts_template_qa.generate_samples(6, seed=7, seq_len=64)))


def test_torch_uts_sample_seq_len_ladder():
    gen = TimeSeriesGenerator(seed=0)
    lengths = {uts_template_qa.sample_seq_len(gen) for _ in range(300)}
    assert 256 in lengths
    assert any(n < 64 for n in lengths) or any(n > 1024 for n in lengths)
    gen2 = TimeSeriesGenerator(seed=0)
    assert all(64 <= n <= 1024 or n == 256 for n in (
        uts_template_qa.sample_seq_len(gen2, disable_extreme=True) for _ in range(300)))


def test_torch_mts_shape_rows_and_correlations():
    rows = list(mts_shape_template_qa.generate_samples(8, seed=0, seq_len=128))
    assert len(rows) == 8
    for row in rows:
        assert row["input"].startswith("There are ")
        n_series = int(row["input"].split(" ")[2])
        assert row["input"].count("<ts><ts/>") == n_series == len(row["timeseries"])
    assert any("trend" in r["input"] for r in rows)
    rows = list(mts_shape_template_qa.generate_samples(40, seed=3, seq_len=128))
    corr = [r for r in rows if "correlation of trend" in r["input"]]
    assert corr
    assert any("similar trends" in r["output"] or "different" in r["output"] for r in corr)


def test_torch_mts_local_rows():
    rows = list(mts_local_template_qa.generate_samples(10, seed=0, seq_len=256))
    assert len(rows) == 10
    find_related = [r for r in rows if "find other time series" in r["input"]]
    assert find_related
    for r in find_related:
        assert ("I found the following" in r["output"]
                or "did not find any other" in r["output"])


# ---------------------------------------------------------------------------
# LLM pipelines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("llm", ("dryrun", "scripted"))
def test_torch_uts_llm_qa_equal_jax(llm):
    port, jax_ = clients(llm)
    for seed, seq_len in ((0, 128), (5, None)):
        got = uts_llm_qa.UTSLLMQAGenerator(seed=seed, seq_len=seq_len).generate_dataset(6, port)
        want = juts_llm.UTSLLMQAGenerator(seed=seed, seq_len=seq_len).generate_dataset(6, jax_)
        assert_same(got, want, f"seed {seed}")


@pytest.mark.parametrize("llm", ("dryrun", "scripted"))
@pytest.mark.parametrize("kind", ("MTSLocalLLMQAGenerator", "MTSShapeLLMQAGenerator"))
def test_torch_mts_llm_qa_equal_jax(kind, llm, tmp_path):
    port, jax_ = clients(llm)
    for seed in (0, 7):
        got = getattr(mts_llm_qa, kind)(seed=seed, seq_len=128).generate_dataset(4, port)
        want = getattr(jmts_llm, kind)(seed=seed, seq_len=128).generate_dataset(4, jax_)
        assert_same(got, want, f"seed {seed}")
    for root, module, out in (("port", mts_llm_qa, got), ("jax", jmts_llm, want)):
        d = tmp_path / root
        module.write_outputs(*out, str(d / "d.jsonl"), str(d / "evol" / "d.json"),
                             str(d / "labels" / "d.json"))
    assert_same_files(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("llm", ("dryrun", "scripted"))
def test_torch_uts_llm_qa_main_writes_the_same_files(llm, tmp_path):
    port, jax_ = clients(llm)
    counts = []
    for root, module, client in (("port", uts_llm_qa, port), ("jax", juts_llm, jax_)):
        d = tmp_path / root
        counts.append(module.main(str(d / "d.jsonl"), str(d / "labels" / "l.json"),
                                  str(d / "evol" / "e.json"), 5, 2, client, seq_len=96))
    assert counts[0] == counts[1] >= 5
    assert_same_files(tmp_path / "port", tmp_path / "jax")


def test_torch_replace_prompts_equal_jax():
    obj = {"a": "see <|prompt0|> and <|prompt1|>", "b": ["<|prompt1|>", 3, None]}
    assert_same(uts_llm_qa.replace_prompts(["X", "Y"], obj),
                juts_llm.replace_prompts(["X", "Y"], obj))
    assert uts_llm_qa.PROMPT_HOLE.pattern == juts_llm.PROMPT_HOLE.pattern


def test_torch_uts_llm_qa_main(tmp_path):
    """tests/test_sft_pipelines.py::test_uts_llm_qa_main, on the port: the
    module's main answers from the dryrun engine."""
    n = uts_llm_qa.main(str(tmp_path / "d.jsonl"), str(tmp_path / "labels.json"),
                        str(tmp_path / "evol.json"), num_data=6, seed=0, seq_len=128)
    assert n >= 6
    rows = [json.loads(line) for line in (tmp_path / "d.jsonl").read_text().splitlines()]
    assert all("<|prompt" not in r["output"] for r in rows)
    assert any("This is a test answer." in r["output"] for r in rows)
    labels = json.loads((tmp_path / "labels.json").read_text())
    assert all("label" in label and "ts_idx" in label for label in labels)
    evol_labels = json.loads((tmp_path / "evol.json").read_text())
    assert all("attribute_pool" in e and "fields" in e for e in evol_labels)
