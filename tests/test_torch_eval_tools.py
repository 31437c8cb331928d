"""The port's time-series tools, ROCKET classifier and trainer, ReAct agent,
GPT baselines and inference driver (``chatts_tpu_torch.eval``) against the
JAX package's, on the same seeded inputs: tool texts and decompositions
equal, ROCKET's features, weights and predictions equal (the same numpy
code on the same draws), a classifier saved by either package loaded by the
other, result files equal. Then the port is held to the assertions of
``tests/test_eval_tools.py``."""
import dataclasses
import json

import numpy as np
import pytest

from chatts_tpu.eval import baselines as jbaselines
from chatts_tpu.eval import inference as jinference
from chatts_tpu.eval import react_agent as jreact
from chatts_tpu.eval import train_rocket_tsc as jtrain
from chatts_tpu.eval import ts_tools as jtools
from chatts_tpu_torch.eval import baselines, inference, react_agent, ts_tools
from chatts_tpu_torch.eval import train_rocket_tsc
from chatts_tpu_torch.utils.llm_client import LLMClient


def _series(seed: int):
    """Three 256-point series: a trend with a period, a noisy copy with a
    spike, and a random walk."""
    rng = np.random.default_rng(seed)
    t = np.arange(256)
    a = 0.02 * t + 3 * np.sin(2 * np.pi * t / 32) + rng.normal(0, 0.2, 256)
    b = a + rng.normal(0, 0.1, 256)
    b[100 + seed] += 8.0
    c = rng.normal(0, 1, 256).cumsum()
    return [a, b, c]


def _same_arrays(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        assert np.array_equal(getattr(got, f.name), getattr(want, f.name)), f.name


@pytest.mark.parametrize("seed", range(3))
def test_torch_ts_tools_equal_jax(seed):
    series = _series(seed)
    cols = ["A", "B", "C"]
    for ts in series + [np.random.default_rng(seed).normal(0, 1, 64)]:
        assert ts_tools.find_period(ts) == jtools.find_period(ts)
        assert ts_tools.find_period(ts, min_period=30) == jtools.find_period(ts, min_period=30)
        for period in (16, 32):
            for robust in (True, False):
                _same_arrays(ts_tools.stl_decompose(ts, period, robust),
                             jtools.stl_decompose(ts, period, robust))
        flags = ts_tools.ar_anomaly_detect(ts)
        assert np.array_equal(flags, jtools.ar_anomaly_detect(ts))
        assert ts_tools.anomaly_block_starts(flags) == jtools.anomaly_block_starts(flags)
        assert ts_tools.stl_tool(ts) == jtools.stl_tool(ts)
        assert ts_tools.anomaly_detection_tool(ts) == jtools.anomaly_detection_tool(ts)
    assert ts_tools.anomaly_detection_multi_tool(series, cols) == \
        jtools.anomaly_detection_multi_tool(series, cols)
    for src in range(3):
        for name in ("correlation_tool", "trend_correlation_tool",
                     "fluctuation_correlation_tool"):
            assert getattr(ts_tools, name)(series, src, cols) == \
                getattr(jtools, name)(series, src, cols), (name, src)


def _toy_problem(seed=2, n=30, length=64):
    """tests/test_eval_tools.py's 3-class toy problem: flat, spike, step."""
    rng = np.random.default_rng(seed)
    X, y = [], []
    for _ in range(n):
        base = rng.normal(0, 0.1, length)
        X.append(base.copy())
        y.append(0)
        spike = base.copy()
        spike[length // 2] += 5
        X.append(spike)
        y.append(1)
        step = base.copy()
        step[length // 2:] += 5
        X.append(step)
        y.append(2)
    return np.stack(X), np.asarray(y)


def test_torch_rocket_equal_jax():
    X, y = _toy_problem()
    clf = ts_tools.RocketClassifier(num_kernels=120, seed=3).fit(X, y)
    jclf = jtools.RocketClassifier(num_kernels=120, seed=3).fit(X, y)
    for f in ("weights", "biases", "dilations", "paddings"):
        assert np.array_equal(getattr(clf.kernels, f), getattr(jclf.kernels, f)), f
    feats = ts_tools._apply_kernels(X, clf.kernels)
    assert np.array_equal(feats, jtools._apply_kernels(X, jclf.kernels))
    for got, want in ((clf.coef, jclf.coef), (clf._mu, jclf._mu), (clf._sigma, jclf._sigma),
                      (clf.classes, jclf.classes)):
        assert np.array_equal(got, want)
    X_test, _ = _toy_problem(seed=9, n=5)
    assert np.array_equal(clf.predict(X_test), jclf.predict(X_test))
    assert np.array_equal(clf.predict(X_test[:, None, :]), jclf.predict(X_test[:, None, :]))


def test_torch_rocket_state_carries_across_packages(tmp_path):
    X, y = _toy_problem()
    X_test, _ = _toy_problem(seed=5, n=6)
    clf = ts_tools.RocketClassifier(num_kernels=100, seed=1).fit(X, y)
    jclf = jtools.RocketClassifier(num_kernels=100, seed=4).fit(X, y)
    clf.save(str(tmp_path / "port.npz"))
    jclf.save(str(tmp_path / "jax.npz"))
    # JAX's file in the port, the port's in JAX: the same classes.
    from_jax = ts_tools.RocketClassifier.load(str(tmp_path / "jax.npz"))
    from_port = jtools.RocketClassifier.load(str(tmp_path / "port.npz"))
    assert np.array_equal(from_jax.predict(X_test), jclf.predict(X_test))
    assert np.array_equal(from_port.predict(X_test), clf.predict(X_test))
    assert np.array_equal(ts_tools.RocketClassifier.load(str(tmp_path / "port.npz"))
                          .predict(X_test), clf.predict(X_test))


def test_torch_rocket_trainer_equal_jax(tmp_path):
    assert train_rocket_tsc.change_type_list == jtrain.change_type_list
    assert len(train_rocket_tsc.change_type_list) == 19
    X, y = train_rocket_tsc.build_dataset(3, seed=1)
    jX, jy = jtrain.build_dataset(3, seed=1)
    assert np.array_equal(X, jX) and np.array_equal(y, jy)
    acc = train_rocket_tsc.train(str(tmp_path / "port" / "r.npz"), samples_per_class=6,
                                 num_kernels=150, seed=0)
    jacc = jtrain.train(str(tmp_path / "jax" / "r.npz"), samples_per_class=6,
                        num_kernels=150, seed=0)
    assert acc == jacc
    got, want = np.load(tmp_path / "port" / "r.npz"), np.load(tmp_path / "jax" / "r.npz")
    assert sorted(got.files) == sorted(want.files)
    for name in want.files:
        assert np.array_equal(got[name], want[name]), name


def test_torch_react_tools_equal_jax(tmp_path):
    X, y = train_rocket_tsc.build_dataset(2, seed=3)
    ts_tools.RocketClassifier(num_kernels=80, seed=0).fit(X, y).save(str(tmp_path / "r.npz"))
    rocket = str(tmp_path / "r.npz")
    series = [s.tolist() for s in _series(4)]
    cols = ["CPU Usage", "Memory", "Disk IO"]
    calls = [
        ("datapoint_value", '{"name": "CPU Usage", "position": 10}'),
        ("datarange_value", '{"name": "Memory", "position_start": 3, "position_end": 9}'),
        ("stl_decomposition", '{"name": "Disk IO"}'),
        ("anomaly_detection", '{"name": "Memory"}'),
        ("anomaly_detection_multi", "{}"),
        ("classification", '{"name": "Memory", "position": 104}'),
        ("classification_multi", '{"position": 100}'),
        ("similarity", '{"name": "CPU Usage"}'),
        ("trend_correlation", '{"name": "Memory"}'),
        ("fluctuation_correlation", '{"name": "Memory"}'),
        ("bogus_tool", "{}"),
        ("datapoint_value", '{"name": "Nope", "position": 1}'),
    ]
    for name, args in calls:
        for path in (rocket, None):
            got = react_agent.call_plugin(name, args, series, cols, path)
            assert got == jreact.call_plugin(name, args, series, cols, path), name
    assert react_agent.build_react_prompt("q?") == jreact.build_react_prompt("q?")


def _scripted(steps):
    def llm(prompt):
        n = prompt.count("\nObservation:")
        return steps[min(n, len(steps) - 1)]
    return llm


def test_torch_react_agent_equal_jax():
    series = [np.sin(np.arange(128) / 10) * 5]
    steps = ["Thought: check.\nAction: datapoint_value\n"
             'Action Input: {"name": "CPU Usage", "position": 10}\nObservation: made up',
             "Action: bogus_tool\nAction Input: {}\n",
             "Thought: I know now.\nFinal Answer: The value is about 4.2."]
    for max_steps in (2, 5):
        got = react_agent.answer_question_react("value at 10?", series, ["CPU Usage"],
                                                _scripted(steps), max_steps=max_steps)
        assert got == jreact.answer_question_react("value at 10?", series, ["CPU Usage"],
                                                   _scripted(steps), max_steps=max_steps)
    assert got == "The value is about 4.2."


def test_torch_react_agent_tool_loop_unknown_tool_and_step_cap():
    ts = [np.sin(np.arange(128) / 10) * 5]
    calls = []

    def scripted_llm(prompt):
        calls.append(prompt)
        if len(calls) == 1:
            return ("Thought: I should check a value.\nAction: datapoint_value\n"
                    'Action Input: {"name": "CPU Usage", "position": 10}\n')
        assert "The value of datapoint 10" in prompt  # the observation fed back
        return "Thought: I know now.\nFinal Answer: The value is about 4.2."

    assert react_agent.answer_question_react(
        "What is the value at point 10?", ts, ["CPU Usage"], scripted_llm) == \
        "The value is about 4.2."
    assert len(calls) == 2

    unknown = []

    def llm(prompt):
        unknown.append(prompt)
        if len(unknown) == 1:
            return "Action: bogus_tool\nAction Input: {}\n"
        assert "not found" in prompt
        return "Final Answer: done"

    assert react_agent.answer_question_react("q", [np.arange(64.0)], ["M"], llm) == "done"

    def looping_llm(prompt):
        return 'Action: datapoint_value\nAction Input: {"name": "M", "position": 0}\n'

    assert "Max steps" in react_agent.answer_question_react(
        "q", [np.arange(8.0)], ["M"], looping_llm, max_steps=3)


def test_torch_ts_tools_behave():
    t = np.arange(512)
    assert 40 <= ts_tools.find_period(np.sin(2 * np.pi * t / 50)) <= 60
    t = np.arange(600)
    res = ts_tools.stl_decompose(0.05 * t + 3 * np.sin(2 * np.pi * t / 50), period=50)
    inner = slice(60, -60)
    assert np.polyfit(t[inner], res.trend[inner], 1)[0] == pytest.approx(0.05, rel=0.2)
    assert np.max(res.seasonal) == pytest.approx(3.0, rel=0.25)
    assert np.std(res.resid[inner]) < 1.0
    ts = np.random.default_rng(1).normal(0, 0.1, 256)
    ts[100] += 8.0
    assert any(98 <= s <= 103 for s in ts_tools.anomaly_block_starts(
        ts_tools.ar_anomaly_detect(ts)))
    clean = np.sin(np.arange(256) / 10)
    assert ts_tools.anomaly_block_starts(ts_tools.ar_anomaly_detect(clean)) == []
    t = np.arange(256)
    a, c = np.sin(t / 20), np.cos(t / 5)
    b = a + 0.01 * np.random.default_rng(0).normal(size=256)
    out = ts_tools.trend_correlation_tool([a, b, c], 0, ["A", "B", "C"])
    assert "B" in out.split("high correlation (>0.7) are:")[1]
    X, y = _toy_problem()
    assert ts_tools.RocketClassifier(num_kernels=200, seed=0).fit(X, y).score(X, y) > 0.9


def _baseline_dataset():
    return [{"question": "What is the trend? <ts><ts/>", "timeseries": [[1, 2, 3]]},
            {"question": "Any spikes? <ts><ts/>", "timeseries": [[5, 50, 5], [1, 1, 2]]}]


def test_torch_baseline_text_and_resume_equal_jax(tmp_path):
    calls = []

    def client(prompt):
        calls.append(prompt)
        return f"answer {len(prompt)}"

    out = tmp_path / "port.json"
    results = baselines.evaluate_gpt_text(_baseline_dataset(), client, str(out), num_workers=2)
    jbaselines.evaluate_gpt_text(_baseline_dataset(), client, str(tmp_path / "jax.json"),
                                 num_workers=2)
    assert len(results) == 2
    assert out.read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert any("1.00, 2.00, 3.00" in c for c in calls)
    n = len(calls)
    baselines.evaluate_gpt_text(_baseline_dataset(), client, str(out), num_workers=2)
    assert len(calls) == n  # resumed: nothing asked again


def test_torch_baseline_agent_equal_jax(tmp_path):
    steps = ["Action: datapoint_value\nAction Input: "
             '{"name": "Time series 1", "position": 1}\n',
             "Final Answer: rising"]
    baselines.evaluate_gpt_agent(_baseline_dataset(), _scripted(steps),
                                 str(tmp_path / "port.json"), num_workers=2)
    jbaselines.evaluate_gpt_agent(_baseline_dataset(), _scripted(steps),
                                  str(tmp_path / "jax.json"), num_workers=2)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert baselines.render_series_text([[1, 2.5]]) == jbaselines.render_series_text([[1, 2.5]])


def test_torch_baseline_vision_renders_image(tmp_path):
    pytest.importorskip("matplotlib")
    import base64

    b64 = baselines.render_series_image([[1, 2, 3], [3, 2, 1]])
    assert base64.b64decode(b64)[:2] == b"\xff\xd8"  # JPEG

    class Chat:
        def chat(self, messages):
            assert messages[0]["content"][1]["image_url"]["url"].startswith(
                "data:image/jpeg;base64,")
            return "ok"

    out = baselines.evaluate_gpt_vision(_baseline_dataset()[:1], Chat(),
                                        str(tmp_path / "v.json"), num_workers=1)
    assert out[0]["response"] == "ok"


def test_torch_inference_shards_and_merge_equal_jax(tmp_path):
    dataset = [{"question": f"q{i} <ts><ts/>", "timeseries": [[1.0, 2.0, 3.0, 4.0]]}
               for i in range(5)]
    client = LLMClient(engine="dryrun", dryrun_sleep_s=0.0, dryrun_output="1. increasing")
    for root, mod in ((tmp_path / "port", inference), (tmp_path / "jax", jinference)):
        for shard in range(2):
            mod.run_inference(dataset, client, "e", exp_root=str(root), shard_idx=shard,
                              num_shards=2, patch_size=2)
    for shard in range(2):
        name = f"generated_answer_2_{shard}.json"
        assert (tmp_path / "port" / "e" / name).read_bytes() == \
            (tmp_path / "jax" / "e" / name).read_bytes()
    merged = inference.merge_shards("e", str(tmp_path / "port"))
    assert merged == jinference.merge_shards("e", str(tmp_path / "jax"))
    assert [m["idx"] for m in merged] == [0, 1, 2, 3, 4]
    assert all(m["response"] == "1. increasing" for m in merged)
    assert inference.CHAT_TEMPLATE == jinference.CHAT_TEMPLATE
    for s in dataset:
        s.update(ability_types=["trend"], cols=[],
                 attributes=[{"type": "increase", "start": 1.0, "amplitude": 3.0}])
    summary = inference.evaluate_experiment(dataset, "e", exp_root=str(tmp_path / "port"),
                                            num_workers=1)
    assert summary["overall_categorical"] == 1.0
    assert json.loads((tmp_path / "port" / "e" / "result.json").read_text()) == summary
