"""The port's SFT family (``chatts_tpu_torch.datagen.sft``: the evol state
machine, TSEvol, rewrite, seed LLM QA, IFT, the three reasoning pipelines;
and ``datagen.seed_template_qa``) against the JAX package's, on the same
seeds and the same LLM answers. Rows, labels, counters and written files must
be equal: the tolerance is exact (``assert_same``, files byte for byte). The
scripted LLMs here are pure functions of the prompt, so the thread pool's
completion order cannot change an answer. The second half holds the port to
the assertions of ``tests/test_sft_chain.py`` and
``tests/test_sft_pipelines.py``."""
import json

import numpy as np
import pytest

from chatts_tpu.datagen import seed_template_qa as jseed_template
from chatts_tpu.datagen.align import mts_llm_qa as jmts_llm
from chatts_tpu.datagen.align import uts_llm_qa as juts_llm
from chatts_tpu.datagen.generator import TimeSeriesGenerator as JTimeSeriesGenerator
from chatts_tpu.datagen.sft import evol as jevol
from chatts_tpu.datagen.sft import generate_ift_dataset as jift
from chatts_tpu.datagen.sft import generate_llm_qa as jllm_qa
from chatts_tpu.datagen.sft import reason as jreason
from chatts_tpu.datagen.sft import rewrite as jrewrite
from chatts_tpu.datagen.sft import tsevol as jtsevol
from chatts_tpu.utils.llm_client import LLMClient as JLLMClient
from chatts_tpu_torch.datagen import seed_template_qa
from chatts_tpu_torch.datagen.align.mts_llm_qa import (MTSLocalLLMQAGenerator,
                                                       MTSShapeLLMQAGenerator)
from chatts_tpu_torch.datagen.align.uts_llm_qa import UTSLLMQAGenerator
from chatts_tpu_torch.datagen.generator import TimeSeriesGenerator
from chatts_tpu_torch.datagen.sft import evol, generate_ift_dataset, generate_llm_qa
from chatts_tpu_torch.datagen.sft import reason, rewrite, tsevol
from chatts_tpu_torch.datagen.sft.evol import attribute_prompt
from chatts_tpu_torch.datagen.sft.reason import (MTS_REASONING_TEMPLATES, MTSReasonGenerator,
                                                 UTS_REASONING_TEMPLATES,
                                                 UTS_REASONING_TEMPLATES_CN,
                                                 UTSReasonGenerator)
from chatts_tpu_torch.datagen.sft.rewrite import RewritePrompt, rewrite_dataset
from chatts_tpu_torch.datagen.sft.tsevol import TSEvolEngine, evol_instruct
from chatts_tpu_torch.utils.llm_client import LLMClient
from tests.test_torch_datagen import assert_same
from tests.test_torch_datagen_align import assert_same_files


def scripted_answer(prompt: str, shape: str = "list") -> str:
    """Answers and verdicts that depend on the prompt alone: a mix of
    accepted and rejected judgements, QA lists for the generators and one QA
    object for the mutation stages."""
    n = len(prompt)
    if "Your Judgement" in prompt:
        return ("Valid", "Invalid(meaning changed)", "Equal", "Valid")[n % 4]
    if "请检查" in prompt:
        return "pass" if n % 2 else "fail"
    if shape == "dict":
        return json.dumps({"question": f"Evolved question {n}?", "answer": f"Answer {n % 101}."})
    return json.dumps([{"question": f"Is point {n % 50} an anomaly?", "answer": f"Yes, {n}."},
                       {"question": "以下哪项正确？A) 上升 B) 下降", "answer": "A。"}],
                      ensure_ascii=False)


def clients(kind, shape="list"):
    """The same LLM for both packages: (port client, JAX client)."""
    if kind == "dryrun":
        out = json.dumps([{"question": "Test?", "answer": "Test."}])
        return tuple(cls(engine="dryrun", dryrun_sleep_s=0.0, dryrun_output=out)
                     for cls in (LLMClient, JLLMClient))
    fake = lambda prompt: scripted_answer(prompt, shape)  # noqa: E731
    return (LLMClient(engine="openai", openai_client=fake),
            JLLMClient(engine="openai", openai_client=fake))


@pytest.fixture(scope="module")
def align_files(tmp_path_factory):
    """Alignment files written by the JAX pipelines, read by both packages'
    TSEvol and IFT: {name: (dataset, evol labels, labels)}."""
    out = tmp_path_factory.mktemp("align")
    fake = JLLMClient(engine="openai", openai_client=lambda p: f"It fits {len(p)}.")
    files = {}
    for name, gen in (("uts_llm_qa", juts_llm.UTSLLMQAGenerator(seed=1, seq_len=96)),
                      ("mts_local_llm_qa", jmts_llm.MTSLocalLLMQAGenerator(seed=2, seq_len=96)),
                      ("mts_shape_llm_qa", jmts_llm.MTSShapeLLMQAGenerator(seed=3, seq_len=96))):
        paths = tuple(str(out / f"{d}{name}.json") for d in ("", "evol_", "labels_"))
        jmts_llm.write_outputs(*gen.generate_dataset(4, fake), *paths)
        files[name] = paths
    return files


# ---------------------------------------------------------------------------
# Evol state machine, TSEvol, rewrite
# ---------------------------------------------------------------------------

def make_seed_evol(module=evol, gen_cls=TimeSeriesGenerator, n_series=2, seq_len=64,
                   seed=0):
    gen = gen_cls(seed=seed)
    series, pools = [], []
    for _ in range(n_series):
        pool = gen.generate_random_attributes(change_positions=[(None, None)],
                                              seq_len=seq_len)
        ts, pool = gen.generate(pool, seq_len)
        series.append(ts)
        pools.append(pool)
    return module.EvolPrompt(
        ts_idx=0, seed_q="What is the trend?", seed_a="It increases.",
        seed_fields={"trend": [0]}, instruction="You are an expert.",
        timeseries=np.stack(series), attribute_pool=pools,
        metrics=["CPU Usage", "Memory Usage", "Disk IO"][:n_series],
        corr_pool=[([0, 1], "CPU and Memory rise together under load.")],
        rng=np.random.default_rng(seed))


@pytest.mark.parametrize("seed", (0, 3))
def test_torch_evol_prompt_equal_jax(seed):
    ep = make_seed_evol(seed=seed)
    jep = make_seed_evol(jevol, JTimeSeriesGenerator, seed=seed)
    for step in range(12):
        ep, jep = ep.clone(), jep.clone()
        ep.evol()
        jep.evol()
        assert ep.fields == jep.fields, step
        assert ep.generate_prompt() == jep.generate_prompt(), step
        q, a = f"q{step}", f"a{step}"
        assert ep.generate_comparison_prompt(q, a) == jep.generate_comparison_prompt(q, a)
        ep.push(q, a)
        jep.push(q, a)
        assert_same(ep.to_dataset(), jep.to_dataset(), f"step {step}")
    assert ep.rng.bit_generator.state == jep.rng.bit_generator.state


def test_torch_attribute_prompt_and_builders_equal_jax():
    ep = make_seed_evol(n_series=3)
    for fields in ({"trend": [0]}, {"seasonal": [0, 2], "noise": [1]}, {"local": [0, 1, 2]},
                   {"statistic": [2], "correlation": [0]},
                   {k: [0] for k in ("trend", "seasonal", "noise", "local", "statistic")}):
        assert (attribute_prompt(ep.timeseries, ep.attribute_pool, ep.metrics, fields,
                                 ep.corr_pool)
                == jevol.attribute_prompt(ep.timeseries, ep.attribute_pool, ep.metrics,
                                          fields, ep.corr_pool))
    for build, jbuild in zip(evol.MUTATION_BUILDERS + rewrite.REWRITE_BUILDERS,
                             jevol.MUTATION_BUILDERS + jrewrite.REWRITE_BUILDERS):
        assert build() == jbuild()
    assert evol.create_comparison_prompt("x", "y") == jevol.create_comparison_prompt("x", "y")


@pytest.mark.parametrize("llm", ("dryrun", "scripted"))
def test_torch_tsevol_equal_jax(llm, align_files, tmp_path):
    port, jax_ = clients(llm, shape="dict")
    seeds = [(ds, ev) for ds, ev, _ in align_files.values()]
    got = evol_instruct(seeds, str(tmp_path / "port" / "evol.jsonl"), 6, port, 4)
    want = jtsevol.evol_instruct(seeds, str(tmp_path / "jax" / "evol.jsonl"), 6, jax_, 4)
    assert_same(got, want)
    assert_same_files(tmp_path / "port", tmp_path / "jax")
    if llm == "scripted":
        assert got
    engine = TSEvolEngine(port, rng=np.random.default_rng(1))
    jengine = jtsevol.TSEvolEngine(jax_, rng=np.random.default_rng(1))
    assert_same(engine.run(tsevol.load_seeds(seeds, engine.rng), 5),
                jengine.run(jtsevol.load_seeds(seeds, jengine.rng), 5))
    assert ((engine.parse_failed, engine.validation_failed)
            == (jengine.parse_failed, jengine.validation_failed))


def _rewrite_seeds(module, gen_cls):
    gen = gen_cls(seed=5)
    seeds = []
    for i in range(3):
        pool = gen.generate_random_attributes(change_positions=[(None, None)], seq_len=64)
        ts, pool = gen.generate(pool, 64)
        seeds.append(module.RewritePrompt(
            ts_idx=i, seed_q=f"What happened {i}?", seed_a="A spike happened.",
            seed_fields={"local": [0], "trend": [0]}, instruction="Expert:",
            timeseries=np.stack([ts]), attribute_pool=[pool], metrics=["CPU Usage"],
            corr_pool=[], rng=np.random.default_rng(i)))
    return seeds


def test_torch_rewrite_dataset_equal_jax(tmp_path):
    port, jax_ = clients("scripted", shape="dict")
    got = rewrite_dataset(_rewrite_seeds(rewrite, TimeSeriesGenerator), 5, port,
                          str(tmp_path / "port" / "rw.jsonl"))
    want = jrewrite.rewrite_dataset(_rewrite_seeds(jrewrite, JTimeSeriesGenerator), 5, jax_,
                                    str(tmp_path / "jax" / "rw.jsonl"))
    assert got
    assert_same(got, want)
    assert_same_files(tmp_path / "port", tmp_path / "jax")


# ---------------------------------------------------------------------------
# Seed QA, IFT, reasoning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("llm", ("dryrun", "scripted"))
def test_torch_llm_qa_equal_jax(llm, tmp_path):
    port, jax_ = clients(llm)
    for seed, seq_len in ((0, 96), (4, None)):
        assert_same(generate_llm_qa.LLMQAGenerator(seed=seed, seq_len=seq_len)
                    .generate_dataset(5, port),
                    jllm_qa.LLMQAGenerator(seed=seed, seq_len=seq_len).generate_dataset(5, jax_))
    for root, module, client in (("port", generate_llm_qa, port), ("jax", jllm_qa, jax_)):
        module.main(str(tmp_path / root / "qa.jsonl"), str(tmp_path / root / "e" / "qa.json"),
                    4, 6, client, seq_len=96)
    assert_same_files(tmp_path / "port", tmp_path / "jax")


def test_torch_seed_template_qa_equal_jax(tmp_path):
    for seed in (0, 2):
        assert_same(seed_template_qa.SeedTemplateQAGenerator(seed=seed, seq_len=96).generate(8),
                    jseed_template.SeedTemplateQAGenerator(seed=seed, seq_len=96).generate(8))
    for root, module in (("port", seed_template_qa), ("jax", jseed_template)):
        assert module.main(str(tmp_path / root / "s.jsonl"), str(tmp_path / root / "l.json"),
                           6, 1) == 6
    assert_same_files(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("encoding_method", ("no", "sp"))
def test_torch_ift_equal_jax(encoding_method, align_files, tmp_path):
    kinds = {"uts_llm_qa": "uts", "mts_local_llm_qa": "local", "mts_shape_llm_qa": "shape"}
    label_files = [(paths[2], kinds[name]) for name, paths in align_files.items()]
    for seed in (0, 1):
        got = generate_ift_dataset.generate_dataset(
            label_files, 8, str(tmp_path / "port" / f"{seed}.jsonl"), seed, encoding_method)
        want = jift.generate_dataset(
            label_files, 8, str(tmp_path / "jax" / f"{seed}.jsonl"), seed, encoding_method)
        assert got == want == 8
    assert_same_files(tmp_path / "port", tmp_path / "jax")
    assert generate_ift_dataset.ALL_LOCAL_TYPES == jift.ALL_LOCAL_TYPES


@pytest.mark.parametrize("llm", ("dryrun", "scripted"))
@pytest.mark.parametrize("kind", ("uts", "mts", "uts_cn"))
def test_torch_reason_equal_jax(kind, llm, tmp_path):
    port, jax_ = clients(llm)

    def make(module, seed):
        if kind == "mts":
            return module.MTSReasonGenerator(seed=seed, seq_len=96)
        return module.UTSReasonGenerator(seed=seed, seq_len=96, chinese=kind == "uts_cn")

    for seed in (0, 5):
        got = make(reason, seed).generate_dataset(3, port)
        want = make(jreason, seed).generate_dataset(3, jax_)
        assert_same(got, want, f"seed {seed}")
    if llm == "scripted":
        assert got[0]
    reason.write_dataset(*got, str(tmp_path / "port" / "r.jsonl"), str(tmp_path / "port" / "l.json"))
    jreason.write_dataset(*want, str(tmp_path / "jax" / "r.jsonl"), str(tmp_path / "jax" / "l.json"))
    assert_same_files(tmp_path / "port", tmp_path / "jax")


def test_torch_reason_templates_equal_jax():
    assert_same(UTS_REASONING_TEMPLATES, jreason.UTS_REASONING_TEMPLATES)
    assert_same(UTS_REASONING_TEMPLATES_CN, jreason.UTS_REASONING_TEMPLATES_CN)
    assert_same(MTS_REASONING_TEMPLATES, jreason.MTS_REASONING_TEMPLATES)
    assert reason.CN_CONSISTENCY_PROMPT == jreason.CN_CONSISTENCY_PROMPT


# ---------------------------------------------------------------------------
# tests/test_sft_chain.py, on the port
# ---------------------------------------------------------------------------

def dryrun(output="This is a test answer."):
    return LLMClient(engine="dryrun", dryrun_sleep_s=0.0, dryrun_output=output)


def qa_llm():
    def fake(prompt):
        if "Your Judgement" in prompt:
            return "Valid"
        if "请检查" in prompt:
            return "pass"
        return json.dumps([
            {"question": "Is there an anomaly?", "answer": "Yes, because of the spike."},
            {"question": "Which option fits? A) X B) Y", "answer": "A. Reasoning."},
        ])

    return LLMClient(engine="openai", openai_client=fake)


def test_torch_mts_local_llm_qa_labels():
    rows, _, labels = MTSLocalLLMQAGenerator(seed=0, seq_len=256).generate_dataset(5, dryrun())
    assert rows and labels
    label = labels[0]["label"]
    assert "cols" in label and "position" in label and "situation" in label
    assert isinstance(label["correlations"], list)
    for corr in label["correlations"]:
        assert set(corr) == {"pair", "explain", "label"}
        assert "<|prompt" not in corr["explain"]
    assert all("<|prompt" not in row["output"] for row in rows)


def test_torch_mts_shape_llm_qa_labels():
    rows, _, labels = MTSShapeLLMQAGenerator(seed=1, seq_len=128).generate_dataset(5, dryrun())
    assert rows
    assert labels[0]["label"]["clusters"], "shape clusters must be recorded"
    cluster = labels[0]["label"]["clusters"][0]
    assert set(cluster) == {"col_idx", "cols", "explain"}
    assert len(cluster["col_idx"]) == len(cluster["cols"])


def test_torch_ift_from_generated_labels(tmp_path):
    _, _, labels = MTSLocalLLMQAGenerator(seed=2, seq_len=256).generate_dataset(4, dryrun())
    label_path = tmp_path / "mts_local_labels.json"
    label_path.write_text(json.dumps(labels))
    _, _, uts_labels = UTSLLMQAGenerator(seed=3, seq_len=128).generate_dataset(4, dryrun())
    uts_path = tmp_path / "uts_labels.json"
    uts_path.write_text(json.dumps(uts_labels))
    out = tmp_path / "ift.jsonl"
    n = generate_ift_dataset.generate_dataset(
        [(str(label_path), "local"), (str(uts_path), "uts")],
        target_cnt=6, output_path=str(out), seed=0)
    assert n == 6
    for row in (json.loads(line) for line in out.read_text().splitlines()):
        assert "answer the following questions" in row["input"]
        assert "1. " in row["input"] and "Strictly formatted answer" in row["input"]
        assert row["output"].startswith("1. ")


def test_torch_uts_reason_generator():
    assert len(UTS_REASONING_TEMPLATES) >= 29
    rows, labels = UTSReasonGenerator(seed=0, seq_len=128).generate_dataset(3, qa_llm())
    assert rows
    assert all("Is there an anomaly?" in r["input"] or "Which option" in r["input"]
               for r in rows)
    assert len(labels) == len(rows)


def test_torch_uts_reason_cn_native_corpus():
    def has_cjk(s):
        return any("一" <= ch <= "鿿" for ch in s)

    assert len(UTS_REASONING_TEMPLATES_CN) >= 30
    assert all(has_cjk(t["example"]) for t in UTS_REASONING_TEMPLATES_CN.values())
    assert ({t["question_type"] for t in UTS_REASONING_TEMPLATES_CN.values()}
            == {"judgment", "multiple_choice", "open_ended"})
    g = UTSReasonGenerator(seed=3, seq_len=128, chinese=True)
    for _ in range(4):
        item = g.generate_prompt_data()
        assert item["template"] in UTS_REASONING_TEMPLATES_CN
        assert has_cjk(item["instruction"]) and has_cjk(item["prompt"])
        assert "Generate QA pairs" not in item["prompt"]
        assert "示例答案" in item["prompt"]


def test_torch_uts_reason_cn_consistency_filter():
    calls = {"checks": 0}

    def fake(prompt):
        if "请检查" in prompt:
            calls["checks"] += 1
            return "pass" if calls["checks"] % 2 == 1 else "fail"
        return json.dumps([{"question": "问题一?", "answer": "答案一."},
                           {"question": "问题二?", "answer": "答案二."}])

    rows, _ = UTSReasonGenerator(seed=1, seq_len=128, chinese=True).generate_dataset(
        2, LLMClient(engine="openai", openai_client=fake))
    assert calls["checks"] > 0
    assert 0 < len(rows) < calls["checks"] + 1


def test_torch_mts_reason_generator():
    assert len(MTS_REASONING_TEMPLATES) >= 6
    rows, _ = MTSReasonGenerator(seed=0, seq_len=128).generate_dataset(3, qa_llm())
    assert rows
    assert all(r["input"].startswith("I have a set of") for r in rows)
    assert all(len(r["timeseries"]) >= 2 for r in rows)


@pytest.mark.parametrize("verdict,expected", (("Valid", 3), ("Invalid(meaning changed)", 0)))
def test_torch_rewrite_dataset(verdict, expected):
    gen = TimeSeriesGenerator(seed=5)
    pool = gen.generate_random_attributes(change_positions=[(None, None)], seq_len=64)
    ts, pool = gen.generate(pool, 64)
    seed = RewritePrompt(
        ts_idx=0, seed_q="What happened?", seed_a="A spike happened.",
        seed_fields={"local": [0]}, instruction="Expert:", timeseries=np.stack([ts]),
        attribute_pool=[pool], metrics=["CPU Usage"], corr_pool=[],
        rng=np.random.default_rng(0))

    def fake(prompt):
        if "Your Judgement" in prompt:
            return verdict
        return '{"question": "Rewritten?", "answer": "Rewritten answer."}'

    rows = rewrite_dataset([seed], total_cnt=3,
                           llm_client=LLMClient(engine="openai", openai_client=fake))
    assert len(rows) == expected
    assert all(r["output"] == "Rewritten answer." for r in rows)


# ---------------------------------------------------------------------------
# tests/test_sft_pipelines.py, on the port
# ---------------------------------------------------------------------------

def scripted_llm(mutation='{"question": "Evolved Q?", "answer": "Evolved A."}',
                 verdict="Valid"):
    def fake(prompt):
        return verdict if "Your Judgement" in prompt else mutation

    return LLMClient(engine="openai", openai_client=fake)


def test_torch_llm_qa_dataset(tmp_path):
    n = generate_llm_qa.main(str(tmp_path / "qa.jsonl"), str(tmp_path / "evol.json"),
                             total_cnt=5, seed=0, seq_len=128)
    assert n >= 5
    rows = [json.loads(line) for line in (tmp_path / "qa.jsonl").read_text().splitlines()]
    assert all("This is a test question." in r["input"] for r in rows)
    assert len(json.loads((tmp_path / "evol.json").read_text())) == len(rows)


def test_torch_evol_unlocks_fields():
    ep = make_seed_evol()
    total_before = sum(len(v) for v in ep.fields.values())
    ep.evol()
    assert sum(len(v) for v in ep.fields.values()) == total_before + 1
    for _ in range(50):
        ep.evol()
    assert sum(len(set(v)) for v in ep.fields.values()) <= 2 * 5 + 1


def test_torch_evol_prompt_contains_context_and_constraints():
    ep = make_seed_evol()
    ep.fields = {"trend": [0], "correlation": [0]}
    prompt = ep.generate_prompt()
    for part in ("#Context#", "#Constraints#", "#The Given Q&A#", "CPU Usage", "rise together"):
        assert part in prompt
    comparison = ep.generate_comparison_prompt("new q", "new a")
    for word in ("Equal", "Invalid", "Valid", "new q"):
        assert word in comparison


def test_torch_qa_history_ring_and_field_restriction():
    ep = make_seed_evol()
    ep.push("q2", "a2")
    ep.push("q3", "a3")
    assert len(ep.qa_history) == 2 and ep.qa_history[-1] == ("q3", "a3")
    text = attribute_prompt(ep.timeseries, ep.attribute_pool, ep.metrics, {"noise": [0]},
                            ep.corr_pool)
    assert "noise information" in text and "trend information" not in text


def test_torch_tsevol_engine_dfs(tmp_path):
    ds_file, label_file = tmp_path / "seed.jsonl", tmp_path / "seed_labels.json"
    ep = make_seed_evol()
    ds_file.write_text(json.dumps({"output": "It increases.",
                                   "timeseries": ep.timeseries.tolist()}) + "\n")
    label_file.write_text(json.dumps([{
        "ts_idx": 0, "question": "What is the trend?", "fields": {"trend": [0]},
        "instruction": "You are an expert.", "metrics": ["CPU Usage", "Memory Usage"],
        "corr_pool": [], "attribute_pool": list(ep.attribute_pool)}]))
    out_file = tmp_path / "evol_out.jsonl"
    rows = evol_instruct([(str(ds_file), str(label_file))], str(out_file), total_cnt=5,
                         llm_client=scripted_llm(), seed=0)
    assert len(rows) == 5
    written = [json.loads(line) for line in out_file.read_text().splitlines()]
    assert len(written) == 5
    assert all(r["output"] == "Evolved A." and "Evolved Q?" in r["input"] for r in written)


@pytest.mark.parametrize("verdict", ("Invalid", "Equal"))
def test_torch_tsevol_rejects(verdict):
    engine = TSEvolEngine(scripted_llm(verdict=verdict), rng=np.random.default_rng(0))
    assert engine.run([make_seed_evol()], total_cnt=5) == []
    if verdict == "Invalid":
        assert engine.validation_failed > 0


def test_torch_tsevol_handles_garbage_mutation():
    engine = TSEvolEngine(scripted_llm(mutation="not json at all"),
                          rng=np.random.default_rng(0))
    assert engine.run([make_seed_evol()], total_cnt=3) == []
    assert engine.parse_failed > 0
