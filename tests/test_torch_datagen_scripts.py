"""The port's dataset scripts (``chatts_tpu_torch.scripts.generate_align_datasets``
and ``generate_sft_datasets``), its generator demo, and the chain from its
generated rows into one LoRA step, against the JAX package.

- With ``CHATTS_LLM_URL`` unset the scripts write the same files, byte for
  byte, as ``scripts/generate_align_datasets.sh`` and
  ``scripts/generate_sft_datasets.sh``, whose commands this file runs
  in-process on the JAX package (each ``python -m`` line through its
  module's ``__main__``, each heredoc through ``exec``).
- With ``CHATTS_LLM_URL`` set, every LLM stage of the port sends its prompts
  to that endpoint (a stdlib fake of ``/v1/chat/completions`` on 127.0.0.1).
  The shell scripts' uts_llm_qa and seed LLM QA stages do not: their module
  mains build a dryrun client. This is the port's chosen difference.
- Rows of the port's alignment pipelines through ``build_sft_batch`` give one
  LoRA step whose loss equals the JAX package's within
  ``tests/test_torch_train.py::LOSS_RTOL``."""
import collections
import importlib.util
import json
import os
import runpy
import shlex
import string
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from chatts_tpu_torch.core.config import tiny_config
from chatts_tpu_torch.datagen.align import mts_shape_template_qa, uts_llm_qa, uts_template_qa
from chatts_tpu_torch.examples import demo_ts_generator
from chatts_tpu_torch.models.convert import from_jax_params
from chatts_tpu_torch.processor.processor import ChatTSProcessor
from chatts_tpu_torch.scripts import generate_align_datasets, generate_sft_datasets
from chatts_tpu_torch.train import data, lora, sft_driver, train_step
from chatts_tpu_torch.utils.llm_client import LLMClient
from tests.test_torch_datagen_align import assert_same_files
from tests.test_torch_datagen_sft import scripted_answer
from tests.test_torch_train import LOSS_RTOL, TINY, Words

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM, SEED = 4, 3
ALIGN_FILES = ("uts_template_qa.jsonl", "mts_shape_template_qa.jsonl",
               "mts_local_template_qa.jsonl", "uts_llm_qa.jsonl", "mts_local_llm_qa.jsonl",
               "mts_shape_llm_qa.jsonl")


def run_shell_script(name, out, monkeypatch, url=None):
    """Run ``scripts/<name>`` in this process: its ``python -m`` lines
    through each module's ``__main__`` and its heredocs through ``exec``,
    with the script's variables. Returns the number of commands run."""
    monkeypatch.setenv("DATA_OUTPUT_DIR", str(out))
    monkeypatch.setenv("NUM_DATA", str(NUM))
    monkeypatch.setenv("SEED", str(SEED))
    if url:
        monkeypatch.setenv("CHATTS_LLM_URL", url)
    else:
        monkeypatch.delenv("CHATTS_LLM_URL", raising=False)
    shell_vars = {"OUT": str(out), "NUM": str(NUM), "SEED": str(SEED)}
    with open(os.path.join(REPO, "scripts", name)) as f:
        lines = iter(f.read().replace("\\\n", " ").splitlines())
    commands = 0
    for line in lines:
        if line.startswith("python -m "):
            module, *args = (string.Template(a).substitute(shell_vars)
                             for a in shlex.split(line)[2:])
            origin = importlib.util.find_spec(module).origin
            monkeypatch.setattr(sys, "argv", [origin, *args])
            runpy.run_path(origin, run_name="__main__")
        elif line == "python - <<'EOF'":
            body = "\n".join(iter(lambda: next(lines), "EOF"))
            exec(compile(body, name, "exec"), {"__name__": "__main__"})
        else:
            continue
        commands += 1
    return commands


def run_port_scripts(out, monkeypatch, url=None, llm_client=None):
    monkeypatch.delenv("CHATTS_LLM_URL", raising=False)
    argv = ["--output-dir", str(out), "--num-data", str(NUM), "--seed", str(SEED)]
    if url:
        argv += ["--llm-url", url]
    return (generate_align_datasets.main(argv, llm_client),
            generate_sft_datasets.main(argv, llm_client))


def answer(prompt: str) -> str:
    """The fake endpoint's answer: one QA object for a mutation prompt, else
    ``scripted_answer``'s, all from the prompt alone."""
    return scripted_answer(prompt, "dict" if "#Generated Q&A#" in prompt else "list")


class _ChatHandler(BaseHTTPRequestHandler):
    def do_POST(self):
        payload = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        prompt = payload["messages"][-1]["content"]
        self.server.prompts.append(prompt)
        body = json.dumps({"choices": [{"message": {"content": answer(prompt)}}]}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


class _ChatServer(ThreadingHTTPServer):
    request_queue_size = 128  # LLMClient opens up to 32 connections at once


@pytest.fixture()
def llm_server():
    server = _ChatServer(("127.0.0.1", 0), _ChatHandler)
    server.prompts = []
    thread = threading.Thread(target=server.serve_forever, args=(0.05,), daemon=True)
    thread.start()
    try:
        yield server, f"http://127.0.0.1:{server.server_port}/v1"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)


def read_rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_torch_scripts_dryrun_equal_jax_scripts(tmp_path, monkeypatch):
    assert run_shell_script("generate_align_datasets.sh", tmp_path / "jax", monkeypatch) == 5
    assert run_shell_script("generate_sft_datasets.sh", tmp_path / "jax", monkeypatch) == 3
    align, sft = run_port_scripts(tmp_path / "port", monkeypatch)
    assert_same_files(tmp_path / "port", tmp_path / "jax")
    for name in ALIGN_FILES:
        assert align[name[:-len(".jsonl")]]["rows"] == len(read_rows(tmp_path / "port" / name))
    assert list(sft) == ["llm_qa", "seed_template_qa", "tsevol", "ift", "uts_reason",
                         "mts_reason", "uts_reason_cn"]
    assert all(stage["rows"] == len(read_rows(tmp_path / "port" / f"{name}.jsonl"))
               for name, stage in sft.items() if name != "tsevol")
    assert "This is a test answer." in read_rows(tmp_path / "port" / "uts_llm_qa.jsonl")[0]["output"]


def test_torch_scripts_send_every_llm_stage_to_the_url(tmp_path, monkeypatch, llm_server):
    server, url = llm_server
    injected = []

    def fake(prompt):
        injected.append(prompt)
        return answer(prompt)

    run_port_scripts(tmp_path / "injected", monkeypatch,
                     llm_client=LLMClient(engine="openai", openai_client=fake))
    run_port_scripts(tmp_path / "port", monkeypatch, url=url)
    # The endpoint saw exactly the prompts an injected client sees, and the
    # files are the same.
    assert collections.Counter(server.prompts) == collections.Counter(injected)
    assert_same_files(tmp_path / "port", tmp_path / "injected")
    port_prompts = collections.Counter(server.prompts)
    # Both stages that the shell scripts leave on dryrun went to the endpoint.
    uts_rows = read_rows(tmp_path / "port" / "uts_llm_qa.jsonl")
    assert not any("This is a test answer." in r["output"] for r in uts_rows)
    assert not any("This is a test question." in r["input"]
                   for r in read_rows(tmp_path / "port" / "llm_qa.jsonl"))
    assert read_rows(tmp_path / "port" / "evol.jsonl")

    # The shell scripts with the same endpoint: uts_llm_qa and the seed LLM
    # QA answer from dryrun, the other LLM stages from the endpoint.
    server.prompts.clear()
    run_shell_script("generate_align_datasets.sh", tmp_path / "jax", monkeypatch, url)
    run_shell_script("generate_sft_datasets.sh", tmp_path / "jax", monkeypatch, url)
    assert all("This is a test answer." in r["output"]
               for r in read_rows(tmp_path / "jax" / "uts_llm_qa.jsonl"))
    assert all("This is a test question." in r["input"]
               for r in read_rows(tmp_path / "jax" / "llm_qa.jsonl"))
    assert 0 < len(server.prompts) < sum(port_prompts.values())
    for name in ("mts_local_llm_qa.jsonl", "mts_shape_llm_qa.jsonl", "uts_reason.jsonl",
                 "mts_reason.jsonl", "uts_reason_cn.jsonl", "mts_local_template_qa.jsonl"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name


def test_torch_scripts_read_the_environment(tmp_path, monkeypatch):
    """Without arguments the scripts take DATA_OUTPUT_DIR, NUM_DATA and SEED,
    as the shell scripts do."""
    monkeypatch.setenv("DATA_OUTPUT_DIR", str(tmp_path / "env"))
    monkeypatch.setenv("NUM_DATA", "2")
    monkeypatch.setenv("SEED", "5")
    monkeypatch.delenv("CHATTS_LLM_URL", raising=False)
    report = generate_align_datasets.main([])
    assert report["uts_template_qa"]["rows"] == 2
    uts_template_qa.main(str(tmp_path / "want.jsonl"), 2, 5)
    assert ((tmp_path / "env" / "uts_template_qa.jsonl").read_bytes()
            == (tmp_path / "want.jsonl").read_bytes())


def test_torch_demo_ts_generator_prints_as_jax_demo(monkeypatch, capsys):
    demo_ts_generator.main(["--seq-len", "128", "--seed", "2"])
    port_out = capsys.readouterr().out
    jax_demo = os.path.join(REPO, "examples", "demo_ts_generator.py")
    monkeypatch.setattr(sys, "argv", [jax_demo, "--seq-len", "128", "--seed", "2"])
    runpy.run_path(jax_demo, run_name="__main__")
    jax_out = capsys.readouterr().out
    # The caption's sampled points come from an unseeded generator in both
    # demos; the rest of the output is a function of --seed.
    assert (port_out.split("Specific data details")[0]
            == jax_out.split("Specific data details")[0])
    assert (port_out.split("\nlocal fluctuations:")[1]
            == jax_out.split("\nlocal fluctuations:")[1])
    assert "=== sp encoding ===" in port_out and "saved plot" not in port_out


def test_torch_generated_rows_give_the_jax_lora_step_loss():
    """Alignment rows the port generated -> build_sft_batch -> one LoRA step
    on the tiny f32 model, against the JAX package on the same rows."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from chatts_tpu.core.config import tiny_config as jtiny
    from chatts_tpu.models import chatts as jchatts
    from chatts_tpu.processor.processor import ChatTSProcessor as JProcessor
    from chatts_tpu.train import data as jdata
    from chatts_tpu.train import lora as jlora
    from chatts_tpu.train import sft_driver as jsft
    from chatts_tpu.train import train_step as jstep

    dryrun = LLMClient(engine="dryrun", dryrun_sleep_s=0.0,
                       dryrun_output="The series rises after the spike.")
    rows = (list(uts_template_qa.generate_samples(2, seed=1, seq_len=48))
            + list(mts_shape_template_qa.generate_samples(1, seed=2, seq_len=32))
            + uts_llm_qa.UTSLLMQAGenerator(seed=3, seq_len=48).generate_dataset(1, dryrun)[0][:1])
    sizes = dict(TINY, max_sequence_length=64)
    jcfg, cfg = jtiny(**sizes), tiny_config(**sizes)
    want_batch = jdata.build_sft_batch(JProcessor(Words(), jcfg), rows, max_answer_tokens=48)
    batch = data.build_sft_batch(ChatTSProcessor(Words(), cfg), rows, max_answer_tokens=48)
    for key in want_batch:
        np.testing.assert_array_equal(batch[key], want_batch[key], err_msg=key)
    assert len(rows) == 4 and batch["ts_mask"].sum() > 0

    # Seeded numpy weights in init_params' tree (traced, not compiled).
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda leaf: jnp.asarray(0.05 * rng.standard_normal(leaf.shape), leaf.dtype),
        jax.eval_shape(lambda: jchatts.init_params(jcfg, jax.random.PRNGKey(0),
                                                   dtype=jnp.float32)))
    jlcfg = jlora.LoRAConfig(rank=4)
    tree = jlora.init_lora(params, jlcfg, jax.random.PRNGKey(1))
    start = jax.tree.map(np.asarray, tree)
    jtc = jstep.TrainConfig(learning_rate=1e-2, remat=False)
    jstep_fn, optimizer = jsft.make_lora_train_step(jcfg, jlcfg, jtc)
    _, _, jmetrics = jstep_fn(tree, optimizer.init(tree), params,
                              {k: jnp.asarray(v) for k, v in want_batch.items()})

    model = from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    adapters = lora.lora_from_jax(start, device="cpu")
    step, _ = sft_driver.make_lora_train_step(
        model, adapters, lora.LoRAConfig(rank=4),
        train_step.TrainConfig(learning_rate=1e-2, remat=False))
    metrics = step(data.to_device(batch, "cpu"))
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                               rtol=LOSS_RTOL)
    assert float(metrics["tokens"]) == float(batch["loss_mask"].sum()) > 0
    assert np.isfinite(float(metrics["loss"]))


def test_torch_script_stage_clients():
    """The caller's client wins; else one OpenAI client for every stage at
    the URL; else a dryrun client with the stage's canned answer."""
    mine = LLMClient(engine="dryrun")
    assert generate_align_datasets.stage_clients(mine, "http://x/v1")("a") is mine
    shared = generate_align_datasets.stage_clients(None, "http://127.0.0.1:9/v1")
    assert shared("a") is shared("b") and shared("a").engine == "openai"
    assert shared("a").openai_client.base_url == "http://127.0.0.1:9/v1"
    assert shared("a").openai_client.timeout_s == 60.0
    assert generate_align_datasets.stage_clients(
        None, "http://127.0.0.1:9/v1", 600.0)("a").openai_client.timeout_s == 600.0
    dry = generate_align_datasets.stage_clients(None, None)
    assert (dry("x").engine, dry("x").dryrun_output, dry("x").dryrun_sleep_s) == ("dryrun", "x", 0.0)
