"""The port's evaluation loop as a whole, the counterpart of
``tests/test_e2e_eval_loop.py``: synthesize an eval dataset, answer it
through ``LLMClient("tpu-ts")`` and the serving engine, score it.

Oracle answers must score high and garbage low. The tiny f32 model of
``tests/test_e2e_eval_loop.py``, moved to the port with ``from_jax_params``,
answers the same dataset greedily through each package's own engine, client,
``run_inference`` and ``evaluate_experiment``: ``generated_answer.json`` and
``result.json`` must be equal (greedy tokens exact, as in every tiny f32
check of the port). Then ``python -m chatts_tpu_torch.scripts.run_eval``'s
``main`` runs with ``--device cpu`` on a checkpoint directory with tokenizer
files. Every engine is stopped on the way out."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chatts_tpu_torch.eval import scorers
from chatts_tpu_torch.eval.inference import evaluate_experiment, run_inference
from chatts_tpu_torch.eval.make_eval_dataset import build_dataset, build_mts_dataset
from chatts_tpu_torch.scripts import run_eval
from chatts_tpu_torch.utils.llm_client import LLMClient
from tests.test_torch_entry_points import ckpt_with_tokenizer  # noqa: F401  (a fixture)


class Oracle:
    """Answers each prompt with its sample's ground truth."""

    def __init__(self, dataset):
        self.by_prompt = {s["question"]: s["answer"] for s in dataset}

    def llm_batch_generate(self, prompts, ts_lists=None, **kw):
        return [self.by_prompt[p.split("<|im_start|>user\n", 1)[1].rsplit("<|im_end|>", 1)[0]]
                for p in prompts]


def test_torch_eval_dataset_schema():
    samples = build_dataset(5, seed=0, seq_len=128)
    assert len(samples) == 5
    for s in samples:
        assert set(s) >= {"question", "timeseries", "ability_types", "attributes", "answer",
                          "cols"}
        assert s["question"].count("<ts><ts/>") == len(s["timeseries"])
        assert len(s["ability_types"]) == len(s["attributes"]) >= 3


def test_torch_oracle_answers_score_high(tmp_path):
    samples = build_dataset(6, seed=1, seq_len=128)
    run_inference(samples, Oracle(samples), "oracle_exp", exp_root=str(tmp_path))
    summary = evaluate_experiment(samples, "oracle_exp", exp_root=str(tmp_path), num_workers=1)
    assert summary["overall_categorical"] >= 0.99
    assert summary["overall_numerical"] >= 0.95


def test_torch_garbage_answers_score_low(tmp_path):
    samples = build_dataset(5, seed=2, seq_len=128)
    client = LLMClient(engine="dryrun", dryrun_sleep_s=0.0,
                       dryrun_output="1. banana\n2. banana\n3. banana\n4. banana")
    run_inference(samples, client, "garbage_exp", exp_root=str(tmp_path))
    summary = evaluate_experiment(samples, "garbage_exp", exp_root=str(tmp_path), num_workers=1)
    assert summary["overall_categorical"] <= 0.2


def test_torch_mts_samples_schema_and_scoring(tmp_path):
    samples = build_mts_dataset(3, seed=0, seq_len=128)
    for s in samples:
        assert s["ability_types"] == ["local_correlation_inductive", "local_cluster_inductive"]
        assert len(s["timeseries"]) == 3 and s["question"].count("<ts><ts/>") == 3
    run_inference(samples, Oracle(samples), "mts_exp", exp_root=str(tmp_path))
    summary = evaluate_experiment(samples, "mts_exp", exp_root=str(tmp_path), num_workers=1)
    assert summary["overall_categorical"] >= 0.99


TINY = dict(vocab_size=256, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, patch_size=16,
            max_sequence_length=256, ts_token_start_index=240)


def _read(root, exp, name):
    with open(root / exp / name) as f:
        return json.load(f)


def test_torch_tiny_eval_loop_equal_jax(tmp_path):
    """tests/test_e2e_eval_loop.py's tiny model, greedy, 8 new tokens: the
    JAX loop (ServeEngine, attn_impl="xla", f32 cache) and the port's
    (ServeEngine on the CPU, f32, plain versions) write the same answers and
    the same scores."""
    from chatts_tpu.core import config as jconfig
    from chatts_tpu.eval.inference import evaluate_experiment as jevaluate_experiment
    from chatts_tpu.eval.inference import run_inference as jrun_inference
    from chatts_tpu.models import chatts
    from chatts_tpu.processor.processor import ChatTSProcessor as JaxProcessor
    from chatts_tpu.serve.scheduler import ServeEngine as JaxServeEngine
    from chatts_tpu.utils.llm_client import LLMClient as JaxLLMClient
    from chatts_tpu_torch.core import config as tconfig
    from chatts_tpu_torch.models.convert import from_jax_params
    from chatts_tpu_torch.processor.processor import ChatTSProcessor
    from chatts_tpu_torch.serve.scheduler import ServeEngine
    from tests.helpers import FakeTokenizer

    jcfg, cfg = jconfig.tiny_config(**TINY), tconfig.tiny_config(**TINY)
    params = chatts.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg)
    samples = build_dataset(2, seed=3, seq_len=64)
    sampling = {"max_tokens": 8, "temperature": 0.0}

    jengine = JaxServeEngine(params, jcfg, JaxProcessor(FakeTokenizer(vocab_limit=200), jcfg),
                             max_batch_size=2, max_model_len=2048, cache_dtype=jnp.float32,
                             attn_impl="xla", decode_chunk=4)
    jclient = JaxLLMClient(engine="tpu-ts", serve_engine=jengine, sampling_params=sampling)
    try:
        jrun_inference(samples, jclient, "tiny", exp_root=str(tmp_path / "jax"),
                       patch_size=jcfg.ts.patch_size)
    finally:
        jclient.kill()
    jsummary = jevaluate_experiment(samples, "tiny", exp_root=str(tmp_path / "jax"),
                                    num_workers=1)

    engine = ServeEngine(model, cfg, ChatTSProcessor(FakeTokenizer(vocab_limit=200), cfg),
                         device="cpu", max_batch_size=2, max_model_len=2048,
                         cache_dtype=torch.float32, decode_chunk=4)
    client = LLMClient(engine="tpu-ts", serve_engine=engine, sampling_params=sampling)
    try:
        run_inference(samples, client, "tiny", exp_root=str(tmp_path / "port"),
                      patch_size=cfg.ts.patch_size)
        # The engine's loop thread is alive: scoring now would not fork.
        assert not scorers.fork_is_safe()
    finally:
        client.kill()
    summary = evaluate_experiment(samples, "tiny", exp_root=str(tmp_path / "port"),
                                  num_workers=2)

    answers = _read(tmp_path / "port", "tiny", "generated_answer.json")
    assert answers == _read(tmp_path / "jax", "tiny", "generated_answer.json")
    assert [len(a["response"].split()) for a in answers] == [8, 8]
    assert summary == jsummary
    assert _read(tmp_path / "port", "tiny", "result.json") == \
        _read(tmp_path / "jax", "tiny", "result.json")
    assert summary["consumed_tokens"] > 0


def test_torch_run_eval_on_a_checkpoint(ckpt_with_tokenizer, tmp_path, monkeypatch,  # noqa: F811
                                        capsys):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("CONFIG_PATH", str(tmp_path / "no_judge.toml"))
    monkeypatch.delenv("CHATTS_JUDGE_URL", raising=False)
    dataset = tmp_path / "dataset.json"
    samples = build_dataset(2, seed=3, seq_len=64)
    dataset.write_text(json.dumps(samples))
    argv = [str(dataset), ckpt_with_tokenizer, "cli_exp", "--exp-root", str(tmp_path / "exp"),
            "--max-tokens", "4", "--max-batch-size", "2", "--max-model-len", "512",
            "--decode-chunk", "4"]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            run_eval.main(argv)
    summary = run_eval.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert json.loads(out[out.index("{\n"):]) == summary
    answers = _read(tmp_path / "exp", "cli_exp", "generated_answer.json")
    assert [a["idx"] for a in answers] == [0, 1]
    assert all(isinstance(a["response"], str) for a in answers)
    assert _read(tmp_path / "exp", "cli_exp", "result.json") == summary
    detailed = _read(tmp_path / "exp", "cli_exp", "detailed_result.json")
    assert [d["idx"] for d in detailed] == [0, 1]
    assert summary["consumed_tokens"] > 0
