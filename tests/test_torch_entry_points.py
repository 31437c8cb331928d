"""The port's user entry points from a checkpoint directory on the CPU: the
quickstart, the OpenAI server's ``build`` answering over HTTP, the streaming
REPL's ``stream_answer`` and ``repl``, and ``LLMClient`` -- none of which
imports the JAX package -- plus their host helpers held to the JAX
package's (``json_utils``, ``extract_and_remove_ts``, ``build_chat_prompt``:
equal outputs on the same inputs).

The checkpoint is the port's synthesized tiny GPTQ directory; where an entry
point needs tokenizer files, a word-level tokenizer is built in-process with
``tokenizers`` and saved beside it (no download; those tests skip without
``transformers``). Every engine is stopped and every wait is bounded."""
import io
import json
import re
import urllib.request

import numpy as np
import pytest

from chatts_tpu.serve import stream_qa as jstream_qa
from chatts_tpu.utils import json_utils as jjson_utils
from chatts_tpu_torch.examples import quickstart, serve_openai
from chatts_tpu_torch.models import weights
from chatts_tpu_torch.processor.processor import ChatTSProcessor
from chatts_tpu_torch.scripts import rehearse_real_checkpoint as rehearsal
from chatts_tpu_torch.serve import stream_qa
from chatts_tpu_torch.serve.scheduler import SamplingParams, ServeEngine
from chatts_tpu_torch.utils import json_utils
from chatts_tpu_torch.utils.llm_client import LLMClient

JSON_INPUTS = [
    '{"a": 1, "b": [1, 2]}',
    'Here you go:\n```json\n{"answer": "yes", "score": 0.5}\n```\nthanks',
    "prefix {'a': True, 'b': None,} suffix",
    "[1, 2, 3,]",
    'text {"s": "a } inside", "n": {"m": [1, {"k": false}]}} tail',
    '{"esc": "quote \\" and brace {"} and more',
    "no json here",
    "",
    None,
    "```\n[{'x': 1}, {'y': 2},]\n```",
    '{"unterminated": [1, 2',
]


@pytest.mark.parametrize("i", range(len(JSON_INPUTS)))
def test_torch_json_utils_equal_jax(i):
    text = JSON_INPUTS[i]
    assert json_utils.parse_llm_json(text) == jjson_utils.parse_llm_json(text)


def test_torch_stream_qa_helpers_equal_jax():
    text = "compare <ts>[1, 2, 3.5]</ts> with <ts>[\n4, -5]</ts> and <ts>[]</ts> now"
    got, want = stream_qa.extract_and_remove_ts(text), jstream_qa.extract_and_remove_ts(text)
    assert got[0] == want[0] == "compare <ts><ts/> with <ts><ts/> and <ts><ts/> now"
    assert len(got[1]) == len(want[1]) == 3
    for a, b in zip(got[1], want[1]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    history = [("q1 <ts><ts/>", "a1"), ("q2", "a2")]
    for hist in ([], history):
        assert stream_qa.build_chat_prompt(hist, "now?") == jstream_qa.build_chat_prompt(hist, "now?")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt")
    rehearsal.synthesize(str(path), shape="tiny", device="cpu", seed=1, log=lambda _: None)
    return str(path)


@pytest.fixture(scope="module")
def engine(ckpt):
    cfg, model = weights.load_checkpoint(ckpt, device="cpu", quantize_bits=4)
    tok = rehearsal.HashTokenizer(cfg.llm.vocab_size)
    # The REPL asks for its default 512 new tokens.
    eng = ServeEngine(model, cfg, ChatTSProcessor(tok, cfg), device="cpu", max_batch_size=2,
                      max_model_len=1024, decode_chunk=32, eos_token_ids=(tok.eos_token_id,),
                      fuse=False)
    yield eng, tok
    eng.stop()


def test_torch_llm_client_dryrun_keeps_order():
    client = LLMClient("dryrun", dryrun_sleep_s=0.0, dryrun_output="x")
    done = []
    out = client.llm_batch_generate([f"p{i}" for i in range(40)],
                                    progress_callback=lambda d, n: done.append((d, n)))
    assert out == ["x"] * 40 and done[-1] == (40, 40)
    with pytest.raises(ValueError, match="unknown engine"):
        LLMClient("vllm")
    with pytest.raises(ValueError, match="requires serve_engine"):
        LLMClient("tpu-ts")


def test_torch_llm_client_on_the_engine(engine):
    eng, tok = engine
    client = LLMClient("tpu-ts", serve_engine=eng,
                       sampling_params={"max_tokens": 3, "temperature": 0.0})
    series = [np.sin(np.arange(64) / 4.0)]
    prompts = ["analyze <ts><ts/> please", "and <ts><ts/> this one"]
    out = client.llm_batch_generate(prompts, [series, series])
    alone = [eng.generate_sync(p, series, SamplingParams(max_tokens=3, temperature=0.0))
             for p in prompts]
    assert out == [tok.decode(r.output_tokens) for r in alone]
    assert all(len(re.findall(r"t\d+", o)) == 3 for o in out)
    text_only = LLMClient("tpu", serve_engine=eng,
                          sampling_params={"max_tokens": 2, "temperature": 0.0})
    with pytest.raises(ValueError, match="text-only"):
        text_only.llm_batch_generate(["x <ts><ts/>"], [series])
    assert len(text_only.llm_batch_generate(["just text"])[0].split()) == 2


def test_torch_stream_answer_and_repl(engine, monkeypatch):
    eng, tok = engine
    eng.start()
    series = [np.arange(32.0)]
    params = SamplingParams(max_tokens=4, temperature=0.0)
    out = io.StringIO()
    prompt = stream_qa.build_chat_prompt([], "what is <ts><ts/> doing")
    text = stream_qa.stream_answer(eng, tok, prompt, series, params, out=out)
    assert out.getvalue() == text + "\n"
    want = eng.generate_sync(prompt, series, params).output_tokens
    assert [int(x) for x in re.findall(r"t(\d+)", text)] == want

    # The REPL through the real stream_answer, with 4 new tokens instead of
    # its 512 and the output kept.
    answers = []

    def short(engine_, tokenizer, prompt_, series_, params_=None, out=None):
        text_ = stream_qa_answer(engine_, tokenizer, prompt_, series_, params, out=io.StringIO())
        answers.append((prompt_, len(series_), text_))
        return text_

    stream_qa_answer = stream_qa.stream_answer
    monkeypatch.setattr(stream_qa, "stream_answer", short)
    lines = iter(["hello <ts>[1, 2, 3, 4]</ts> there", "and then", "clear", "again", "exit"])
    monkeypatch.setattr("builtins.input", lambda _prompt: next(lines))
    stream_qa.repl(eng, tok)
    assert [n for _, n, _ in answers] == [1, 1, 0]
    assert "hello <ts><ts/> there" in answers[1][0] and answers[0][2] in answers[1][0]
    assert "hello" not in answers[2][0]
    assert all(len(re.findall(r"t\d+", text_)) == 4 for _, _, text_ in answers)


@pytest.fixture(scope="module")
def ckpt_with_tokenizer(tmp_path_factory):
    pytest.importorskip("transformers")
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    path = tmp_path_factory.mktemp("ckpt_tok")
    rehearsal.synthesize(str(path), shape="tiny", device="cpu", seed=2, log=lambda _: None)
    words = ["[UNK]", "[PAD]", "[EOS]"] + [f"w{i}" for i in range(200)] + [
        "I", "have", "a", "time", "series", "length", "of", "256:", "Please", "analyze",
        "the", "local", "changes", "in", "this", "series."]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]", pad_token="[PAD]",
                                   eos_token="[EOS]")
    fast.save_pretrained(str(path))
    return str(path)


def test_torch_quickstart_from_a_checkpoint(ckpt_with_tokenizer, ckpt, monkeypatch, capsys):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    text = quickstart.main(["--model", ckpt_with_tokenizer, "--device", "cpu",
                            "--max-new-tokens", "3"])
    printed = capsys.readouterr().out
    assert "TTFT" in printed and "on cpu" in printed and printed.rstrip().endswith(text)
    assert weights.load_tokenizer(ckpt_with_tokenizer).eos_token_id == 2
    assert weights.load_tokenizer(ckpt) is None
    with pytest.raises(SystemExit, match="no tokenizer files"):
        quickstart.main(["--model", ckpt, "--device", "cpu"])


def test_torch_quickstart_tiny_random(capsys):
    quickstart.main(["--device", "cpu", "--max-new-tokens", "2"])
    assert "tiny-random" in capsys.readouterr().out


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_torch_serve_openai_build_answers_over_http(ckpt_with_tokenizer, monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    args = serve_openai.parse_args([
        "--model", ckpt_with_tokenizer, "--device", "cpu", "--quantize-int4", "--kv-int8",
        "--no-warmup", "--host", "127.0.0.1", "--port", "0", "--max-batch-size", "2",
        "--max-model-len", "512", "--decode-chunk", "4"])
    engine, server = serve_openai.build(args)
    assert engine.device.type == "cpu" and engine.cache_dtype.is_floating_point is False
    assert engine.model.llm.layers[0].self_attn.q_proj.kernel_q4 is not None  # unfused GPTQ
    server.start_background()
    try:
        assert server._httpd is not None
        body = {"model": "chatts", "max_tokens": 3, "temperature": 0.0,
                "messages": [{"role": "user", "content": [
                    {"type": "text", "text": "Please analyze"},
                    {"type": "timeseries", "timeseries": list(np.sin(np.arange(48) / 3.0))},
                    {"type": "text", "text": "the local changes"}]}]}
        data = _post(server._httpd.server_address[1], body)
        assert data["choices"][0]["finish_reason"] in ("length", "stop")
        assert 1 <= data["usage"]["completion_tokens"] <= 3
    finally:
        server.shutdown()


def test_torch_serve_openai_takes_prefill_chunk(ckpt_with_tokenizer, monkeypatch):
    """``--prefill-chunk 64`` builds a server whose engine has it, and a chat
    request above 64 prompt tokens is admitted by the scan-sliced round."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    args = serve_openai.parse_args([
        "--model", ckpt_with_tokenizer, "--device", "cpu", "--no-warmup", "--host",
        "127.0.0.1", "--port", "0", "--max-batch-size", "2", "--max-model-len", "512",
        "--decode-chunk", "4", "--prefill-chunk", "64"])
    engine, server = serve_openai.build(args)
    assert engine.prefill_chunk == 64
    server.start_background()
    try:
        body = {"model": "chatts", "max_tokens": 3, "temperature": 0.0,
                "messages": [{"role": "user", "content": [
                    {"type": "text", "text": "Please analyze"},
                    {"type": "timeseries", "timeseries": list(np.sin(np.arange(160) / 3.0))},
                    {"type": "text", "text": "the local changes " * 30}]}]}
        data = _post(server._httpd.server_address[1], body)
        assert data["choices"][0]["finish_reason"] in ("length", "stop")
        assert 1 <= data["usage"]["completion_tokens"] <= 3
        assert data["usage"]["prompt_tokens"] > 64
        assert engine.stats()["rounds_mixed"] >= 1
    finally:
        server.shutdown()
