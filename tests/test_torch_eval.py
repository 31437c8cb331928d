"""The port's eval harness (``chatts_tpu_torch.eval``: the dataset builders,
the scorers, batch scoring and its pool, the answer-correctness judge, its
TOML config and its HTTP client) against the JAX package's, on the same
seeds and answers. Datasets are held byte for byte (sorted-key JSON), scores
and result files exactly. The judge is driven with a scripted LLM and over a
local HTTP server on 127.0.0.1, as ``tests/test_eval.py``,
``tests/test_misc_parity.py`` and ``tests/test_judge_http.py`` drive the JAX
one."""
import difflib
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest
import torch

from chatts_tpu.eval import make_eval_dataset as jmake
from chatts_tpu.eval import ragas_judge as jragas
from chatts_tpu.eval import scorers as jscorers
from chatts_tpu_torch.eval import judge_config, make_eval_dataset, ragas_judge, scorers
from chatts_tpu_torch.eval.inference import evaluate_experiment, run_inference
from chatts_tpu_torch.eval.openai_client import OpenAIClient
from chatts_tpu_torch.eval.ragas_judge import AnswerCorrectnessJudge


def _dump(samples) -> str:
    return json.dumps(samples, sort_keys=True)


@pytest.mark.parametrize("seq_len", (128, None))
@pytest.mark.parametrize("seed", range(4))
def test_torch_build_dataset_equal_jax(seed, seq_len):
    got = make_eval_dataset.build_dataset(6, seed=seed, seq_len=seq_len)
    assert _dump(got) == _dump(jmake.build_dataset(6, seed=seed, seq_len=seq_len))
    if seq_len is None:
        assert all(64 <= len(s["timeseries"][0]) <= 1024 for s in got)


@pytest.mark.parametrize("seed", range(4))
def test_torch_build_mts_dataset_equal_jax(seed):
    got = make_eval_dataset.build_mts_dataset(3, seed=seed, seq_len=128)
    assert _dump(got) == _dump(jmake.build_mts_dataset(3, seed=seed, seq_len=128))


def test_torch_make_eval_dataset_main_writes_the_same_file(tmp_path):
    make_eval_dataset.main(str(tmp_path / "port.json"), 4, seed=9, seq_len=96)
    jmake.main(str(tmp_path / "jax.json"), 4, seed=9, seq_len=96)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


# ---------------------------------------------------------------------------
# Scorers: oracle, garbage and perturbed answers
# ---------------------------------------------------------------------------

def ratio_judge(question, response, label):
    """A deterministic judge: the answer's similarity to the label."""
    score = difflib.SequenceMatcher(None, response.lower(), label.lower()).ratio()
    return round(score, 6), {"q": question[:20], "len": len(response)}


def _perturb(text: str) -> str:
    """Every number moved by 30% plus one, and 'increase'/'decrease' swapped."""
    text = re.sub(r"-?\d+(?:\.\d+)?", lambda m: f"{float(m.group()) * 1.3 + 1:.2f}", text)
    return text.replace("increas", "XX").replace("decreas", "increas").replace("XX", "decreas")


HAND_CASES = {
    "local_inductive": (
        [{"type": "upward spike", "position": 40, "amplitude": 8.0,
          "explain": "A burst of load."}],
        ["Time Series"],
        "an upward spike around point 44, with an amplitude of 7.5. It is a burst of load."),
    "shape_correlation_inductive": (
        {"label": True, "explain": "They share a workload."}, ["A", "B"],
        "Yes, they are correlated. They share a workload."),
    "shape_cluster_inductive": (
        {"cols": ["cpu_usage", "mem_usage"], "explain": "because"},
        ["cpu_usage", "mem_usage", "disk_io"],
        "cpu_usage, mem_usage. Because they share load."),
    "deductive": ("Yes. The series rises after the fault.", [],
                  "Yes. It rises after the fault."),
    "causal": ("CPU Usage. It drives the others.", [], "CPU usage is the cause."),
    "MCQ2": ("B", [], "the answer is B"),
}


def _cases():
    """(ability, attribute, cols, oracle answer) from the synthetic datasets
    and the hand cases, covering every scorer of the registry."""
    cases = []
    samples = (make_eval_dataset.build_dataset(8, seed=1, seq_len=128)
               + make_eval_dataset.build_mts_dataset(2, seed=0, seq_len=128))
    for s in samples:
        parts = scorers.split_numbered_answers(s["answer"], len(s["attributes"]))
        for ability, attr, part in zip(s["ability_types"], s["attributes"], parts):
            cases.append((ability, attr, s["cols"], part))
    for ability, (attr, cols, oracle) in HAND_CASES.items():
        cases.append((ability, attr, cols, oracle))
    cases.append(("deductive", "The series rises because of the fault.", [],
                  "It rises because of a fault."))
    cases.append(("shape_correlation_inductive", {"label": False, "explain": "unrelated"},
                  ["A", "B"], "No. They are unrelated."))
    return cases


CASES = _cases()


@pytest.mark.parametrize("ability", sorted(jscorers.SCORER_REGISTRY))
def test_torch_scorer_equal_jax(ability):
    assert sorted(scorers.SCORER_REGISTRY) == sorted(jscorers.SCORER_REGISTRY)
    mine = [c for c in CASES if c[0] == ability]
    assert mine, ability
    for _, attr, cols, oracle in mine:
        for answer in (oracle, "banana. banana", _perturb(oracle), ""):
            got = scorers.ability_scorer(ability)(answer, attr, cols, ratio_judge)
            want = jscorers.ability_scorer(ability)(answer, attr, cols, ratio_judge)
            assert got == want, (ability, answer)


def test_torch_evaluate_qa_and_helpers_equal_jax():
    samples = (make_eval_dataset.build_dataset(6, seed=2, seq_len=None)
               + make_eval_dataset.build_mts_dataset(2, seed=3, seq_len=128))
    for s in samples:
        for answer in (s["answer"], "1. banana\n2. banana\n3. banana\n4. banana",
                       _perturb(s["answer"]), s["answer"].replace("\n", " "), "no numbers"):
            assert scorers.evaluate_qa(answer, s, ratio_judge) == \
                jscorers.evaluate_qa(answer, s, ratio_judge)
            for n in (1, 3, 4):
                assert scorers.split_numbered_answers(answer, n) == \
                    jscorers.split_numbered_answers(answer, n)
            assert scorers.split_sentences(answer) == jscorers.split_sentences(answer)


def _generated(samples, seed):
    """Oracle, garbage and perturbed answers, one per sample in turn, and one
    sample left unanswered."""
    rng = np.random.default_rng(seed)
    out = []
    for i, s in enumerate(samples[:-1]):
        kind = i % 3
        response = (s["answer"] if kind == 0 else "1. banana\n2. banana" if kind == 1
                    else _perturb(s["answer"]))
        out.append({"idx": i, "response": response, "num_tokens": int(rng.integers(10, 99))})
    return out


def _result_files(root, exp):
    return [(root / exp / name).read_bytes() for name in ("result.json", "detailed_result.json")]


def test_torch_evaluate_batch_qa_files_equal_jax(tmp_path):
    samples = (make_eval_dataset.build_dataset(7, seed=4, seq_len=None)
               + make_eval_dataset.build_mts_dataset(2, seed=4, seq_len=128))
    generated = _generated(samples, 0)
    got = scorers.evaluate_batch_qa(samples, generated, "e", num_workers=1,
                                    judge=ratio_judge, exp_root=str(tmp_path / "port"))
    want = jscorers.evaluate_batch_qa(samples, generated, "e", num_workers=1,
                                      judge=ratio_judge, exp_root=str(tmp_path / "jax"))
    assert got == want
    assert _result_files(tmp_path / "port", "e") == _result_files(tmp_path / "jax", "e")
    assert got["consumed_tokens"] == sum(g["num_tokens"] for g in generated)
    detailed = json.loads((tmp_path / "port" / "e" / "detailed_result.json").read_text())
    assert [d["idx"] for d in detailed] == list(range(len(samples) - 1))


def test_torch_scoring_pools_agree(tmp_path, monkeypatch):
    """Forked processes, threads and one worker give the same summary and
    the same files."""
    samples = make_eval_dataset.build_dataset(9, seed=5, seq_len=None)
    generated = _generated(samples, 1)
    runs = {}
    for name, workers, fork in (("one", 1, True), ("process", 4, True),
                                ("thread", 4, False)):
        monkeypatch.setattr(scorers, "fork_is_safe", lambda fork=fork: fork)
        summary = scorers.evaluate_batch_qa(samples, generated, name, num_workers=workers,
                                            exp_root=str(tmp_path))
        runs[name] = (summary, _result_files(tmp_path, name))
    assert runs["process"] == runs["thread"] == runs["one"]


def test_torch_scoring_pool_choice(tmp_path, monkeypatch):
    """Scoring forks only from a process with no CUDA context and no other
    thread; otherwise it scores on threads."""
    made = []

    class Spy(scorers.ThreadPoolExecutor):
        def __init__(self, max_workers, mp_context=None):
            made.append("process" if mp_context is not None else "thread")
            super().__init__(max_workers)

    monkeypatch.setattr(scorers, "ProcessPoolExecutor", Spy)
    monkeypatch.setattr(scorers, "ThreadPoolExecutor", Spy)
    samples = make_eval_dataset.build_dataset(3, seed=6, seq_len=64)
    generated = _generated(samples, 2)

    def choose():
        made.clear()
        scorers.evaluate_batch_qa(samples, generated, "c", num_workers=2,
                                  exp_root=str(tmp_path))
        return made[0]

    monkeypatch.setattr(threading, "active_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert scorers.fork_is_safe() and choose() == "process"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert not scorers.fork_is_safe() and choose() == "thread"
    monkeypatch.undo()
    # A live thread, as a serving engine's loop is, rules the fork out.
    stop = threading.Event()
    loop = threading.Thread(target=stop.wait, daemon=True)
    loop.start()
    try:
        assert not scorers.fork_is_safe()
    finally:
        stop.set()
        loop.join(timeout=10)
    assert not loop.is_alive()


# ---------------------------------------------------------------------------
# The answer-correctness judge, its config and its HTTP client
# ---------------------------------------------------------------------------

def _fake_llm(calls):
    def llm(prompt):
        calls.append(prompt)
        if "gt_keywords" in prompt and "overlapping" not in prompt:
            return '{"gt_keywords": ["nuclear fusion", "light"]}'
        return '{"overlapping_keywords": ["light"]}'
    return llm


def test_torch_judge_with_fake_llm_equal_jax(tmp_path):
    calls, jcalls = [], []
    judge = AnswerCorrectnessJudge(_fake_llm(calls), data_dir=str(tmp_path / "port"))
    jjudge = jragas.AnswerCorrectnessJudge(_fake_llm(jcalls), data_dir=str(tmp_path / "jax"))
    for response in ("It emits light", "another answer"):
        got = judge("What powers the sun?", response, "fusion and light")
        assert got == jjudge("What powers the sun?", response, "fusion and light")
    assert got[0] == pytest.approx(0.5)
    assert got[1]["num_ok"] == 1 and got[1]["num_all"] == 2
    # Keyword extraction is cached: the second call asked only for the overlap.
    assert calls == jcalls and len(calls) == 3
    assert (tmp_path / "port" / "gt_cache.json").read_bytes() == \
        (tmp_path / "jax" / "gt_cache.json").read_bytes()
    # The cache outlives the instance.
    again = AnswerCorrectnessJudge(_fake_llm(calls), data_dir=str(tmp_path / "port"))
    again("What powers the sun?", "light", "fusion and light")
    assert len(calls) == 4


def test_torch_judge_error_fallback_and_fuzzy_match(tmp_path):
    def broken(prompt):
        raise ConnectionError("api down")

    score, detail = AnswerCorrectnessJudge(broken, data_dir=str(tmp_path))("q", "r", "label")
    assert score == 0.0 and "error" in detail

    def llm(prompt):
        if "overlapping" not in prompt:
            return '{"gt_keywords": ["maintain a healthy weight"]}'
        return '{"overlapping_keywords": ["maintains healthy weight"]}'

    judge = AnswerCorrectnessJudge(llm, data_dir=str(tmp_path / "f"))
    score, _ = judge("benefits?", "it maintains healthy weight", "maintain a healthy weight")
    assert score == 1.0  # difflib ratio >= 0.6
    assert ragas_judge.calculate_ragas_score("q", "r", "l") == \
        jragas.calculate_ragas_score("q", "r", "l")
    assert ragas_judge.GT_KEYWORDS_PROMPT == jragas.GT_KEYWORDS_PROMPT
    assert ragas_judge.OVERLAP_PROMPT == jragas.OVERLAP_PROMPT


def test_torch_judge_config(judge_server, tmp_path, monkeypatch):
    from chatts_tpu.eval import judge_config as jjudge_config

    monkeypatch.setenv("CONFIG_PATH", str(tmp_path / "nope.toml"))
    monkeypatch.delenv("CHATTS_JUDGE_URL", raising=False)
    assert judge_config.load_config() == {}
    assert judge_config.load_judge() is None
    cfg_file = tmp_path / "judge.toml"
    cfg_file.write_text('[llm]\nmodel = "test-model"\napi_base = "http://127.0.0.1:%d/v1"\n'
                        '[data]\ndata_dir = "%s"\n' % (judge_server.server_port, tmp_path))
    monkeypatch.setenv("CONFIG_PATH", str(cfg_file))
    assert judge_config.load_config() == jjudge_config.load_config()
    assert judge_config.load_config()["llm"]["model"] == "test-model"
    judge = judge_config.load_judge()
    assert isinstance(judge, AnswerCorrectnessJudge)
    assert vars(judge.llm) == vars(jjudge_config.load_judge().llm)
    label = "a sudden decrease happens near the end"
    assert judge("q", label, label)[0] == 1.0
    assert judge_server.requests[-1]["model"] == "test-model"


def _keyword_llm(prompt: str) -> str:
    """tests/test_judge_http.py's keyword LLM: the ground truth's first words
    as the keyword, overlaps by substring."""
    if '"gt_keywords"' in prompt and "ground_truth:" in prompt:
        gt = prompt.rsplit("ground_truth:", 1)[1].split("Output only", 1)[0].strip()
        words = gt.replace("\n", " ").split()
        kw = " ".join(words[:4]) if words else ""
        return json.dumps({"gt_keywords": [kw] if kw else []})
    if '"overlapping_keywords"' in prompt and "gt_keywords:" in prompt:
        tail = prompt.rsplit("gt_keywords:", 1)[1]
        keywords = json.loads(tail.split("\n", 1)[0].strip())
        answer = tail.split("answer:", 1)[1].split("Output only", 1)[0].strip()
        return json.dumps({"overlapping_keywords": [
            k for k in keywords if str(k).lower() in answer.lower()]})
    return "{}"


class _JudgeHandler(BaseHTTPRequestHandler):
    def do_POST(self):
        payload = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        self.server.requests.append(payload)
        body = json.dumps({"choices": [{"message": {
            "content": _keyword_llm(payload["messages"][-1]["content"])}}]}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


@pytest.fixture()
def judge_server():
    server = HTTPServer(("127.0.0.1", 0), _JudgeHandler)
    server.requests = []
    thread = threading.Thread(target=server.serve_forever, args=(0.05,), daemon=True)
    thread.start()
    try:
        yield server
    finally:
        server.shutdown()
        thread.join(timeout=5)


def _http_judge(server, data_dir, judge_cls=AnswerCorrectnessJudge, client_cls=OpenAIClient):
    client = client_cls(base_url=f"http://127.0.0.1:{server.server_port}/v1",
                        max_retries=2, timeout_s=10.0)
    return judge_cls(client, data_dir=str(data_dir))


def test_torch_judge_over_http_equal_jax(judge_server, tmp_path):
    from chatts_tpu.eval.openai_client import OpenAIClient as JOpenAIClient

    label = "the cpu usage rises sharply at position 120"
    judge = _http_judge(judge_server, tmp_path / "port")
    assert judge("what happens to cpu usage?", label, label)[0] == 1.0
    assert judge("what happens to cpu usage?", "bananas", label)[0] == 0.0
    assert len(judge_server.requests) == 3  # extraction cached for the second
    port_requests = list(judge_server.requests)
    judge_server.requests.clear()
    jjudge = _http_judge(judge_server, tmp_path / "jax", jragas.AnswerCorrectnessJudge,
                         JOpenAIClient)
    jjudge("what happens to cpu usage?", label, label)
    jjudge("what happens to cpu usage?", "bananas", label)
    # The same request bodies on the wire.
    assert judge_server.requests == port_requests


def test_torch_judge_http_error_falls_back_to_zero(tmp_path):
    client = OpenAIClient(base_url="http://127.0.0.1:9/v1", max_retries=1, timeout_s=0.5)
    score, detail = AnswerCorrectnessJudge(client, data_dir=str(tmp_path))("q", "r", "label")
    assert score == 0.0 and "error" in detail


def test_torch_load_judge_from_env_url(judge_server, tmp_path, monkeypatch):
    monkeypatch.setenv("CHATTS_JUDGE_URL", f"http://127.0.0.1:{judge_server.server_port}/v1")
    monkeypatch.setenv("CONFIG_PATH", str(tmp_path / "missing.toml"))
    monkeypatch.chdir(tmp_path)
    judge = judge_config.load_judge()
    label = "noise level is high throughout"
    assert judge("noise?", label, label)[0] == 1.0


def test_torch_reason_scores_flow_through_eval_loop(judge_server, tmp_path):
    samples = make_eval_dataset.build_mts_dataset(3, seed=4, seq_len=128)

    class Oracle:
        def llm_batch_generate(self, prompts, ts_lists=None, **kw):
            by_prompt = {x["question"]: x["answer"] for x in samples}
            return [by_prompt[p.split("<|im_start|>user\n", 1)[1].rsplit("<|im_end|>", 1)[0]]
                    for p in prompts]

    run_inference(samples, Oracle(), "judge_exp", exp_root=str(tmp_path))
    judge = _http_judge(judge_server, tmp_path / "judge_data")
    summary = evaluate_experiment(samples, "judge_exp", exp_root=str(tmp_path),
                                  num_workers=1, judge=judge)
    assert judge_server.requests
    assert summary["overall_reason"] >= 0.9
    assert summary["overall_categorical"] >= 0.99
