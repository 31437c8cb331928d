"""Tensor-parallel serving in the port at tp = 2, on a real ``gloo`` world of
two CPU processes, against the JAX package's single-device batch engine.

One world (``run_world``, a ``file://`` store under the test's temporary
directory) runs every case of this module once: rank 0 drives each
``ServeEngine`` (its loop thread, or by hand for the mixed admission) and
rank 1 runs ``follow()`` on its shard until the driver stops.  The ranks
import nothing of JAX; this process compares their results with JAX's
``InferenceEngine`` (f32 weights, XLA attention, per-step scatter decode,
each request alone), token for token:

- the batch engine at tp = 2;
- a plain request, also through ``ChatTSServer``'s ``/v1/completions``; a
  long prompt admitted in chunks (``prefill_chunk``) by the scan-sliced
  path; an int8 KV cache; and an admission that arrives
  while a request decodes, taking the mixed path (block budget 0, driven
  on one thread as ``tests/test_torch_mixed_admission.py`` drives it), the
  case of ``tests/test_multichip_inference.py:103-146``.

At dp = 2 (tp = 1), each rank holding the whole model, world rank 0
drives and the rank of the other dp group follows: the plain request and
the mixed admission give JAX's tokens on both replicas.

It also holds what the engine refuses or chooses: ``submit`` and
``start`` on a follower, and eager decode rounds off the card, reported by
``stats()``.  The world's join is bounded (60 s)."""
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from chatts_tpu_torch.core import config as tconfig
from chatts_tpu_torch.core.config import GenerationConfig
from chatts_tpu_torch.models.convert import from_jax_params
from chatts_tpu_torch.parallel import distributed, sharding
from chatts_tpu_torch.parallel import mesh as tmesh
from chatts_tpu_torch.processor.processor import ChatTSProcessor
from chatts_tpu_torch.runtime.engine import InferenceEngine
from chatts_tpu_torch.serve.scheduler import Request, SamplingParams, ServeEngine
from chatts_tpu_torch.serve.server import ChatTSServer
from tests.helpers import FakeTokenizer

WORLD_TIMEOUT_S = 60

# tests/test_multichip_inference.py:19-27
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=8, num_key_value_heads=4, patch_size=4,
            max_sequence_length=64, ts_token_start_index=240)
BATCH = (["analyze <ts><ts/> now", "and <ts><ts/> too"],
         [np.arange(12.0), np.sin(np.arange(8.0))])
PLAIN = ("serve <ts><ts/> sharded", [np.arange(12.0)], 6)
LONG = ("analyze <ts><ts/> " + "tok " * 150, [np.arange(16.0)], 6)
RUNNER = ("runner <ts><ts/> decodes long", [np.arange(12.0)], 30)
JOINS = ("joins <ts><ts/> mid flight", [np.sin(np.arange(8.0))], 5)
# Each engine's keyword arguments; one list for the driver and the follower.
ENGINES = [
    dict(cache_dtype=torch.float32, prefill_chunk=32),  # plain, then the long prompt
    dict(cache_dtype=torch.int8),  # plain, int8 cache
    dict(cache_dtype=torch.float32, block_token_budget=0),  # the mixed admission
]


def _engine(model, cfg, proc, kw):
    kw = dict(kw)
    budget = kw.pop("block_token_budget", None)
    engine = ServeEngine(model, cfg, proc, device="cpu", max_batch_size=4, max_model_len=256,
                         decode_chunk=4, **kw)
    if budget is not None:
        engine.block_token_budget = budget
    return engine


def _greedy(spec):
    prompt, series, n = spec
    return Request(prompt, series, SamplingParams(max_tokens=n, temperature=0.0))


def _drive(engines):
    """Rank 0: every case through its engine; the followers stop with each."""
    out = {}
    with engines[0] as eng:
        for name, spec in (("plain", PLAIN), ("long", LONG)):
            out[name] = eng.generate_sync(*spec[:2], _greedy(spec).params,
                                          timeout=WORLD_TIMEOUT_S).output_tokens
        out["stats"] = eng.stats()
        out["long_kinds"] = sorted({r["kind"] for r in eng.round_snapshot()})
        # The plain request again over HTTP; the server's shutdown stops the
        # engine and, through it, the follower.
        server = ChatTSServer(eng, FakeTokenizer(vocab_limit=200), host="127.0.0.1", port=0)
        server.start_background()
        try:
            body = json.dumps({"prompt": PLAIN[0], "timeseries": [list(PLAIN[1][0])],
                               "max_tokens": PLAIN[2], "temperature": 0.0}).encode()
            request = urllib.request.Request(
                f"http://127.0.0.1:{server._httpd.server_address[1]}/v1/completions",
                data=body, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(request, timeout=WORLD_TIMEOUT_S) as response:
                text = json.loads(response.read())["choices"][0]["text"]
            out["http"] = [int(word[3:]) for word in text.split()]
        finally:
            server.shutdown()
    with engines[1] as eng:
        out["int8"] = eng.generate_sync(*PLAIN[:2], _greedy(PLAIN).params,
                                        timeout=WORLD_TIMEOUT_S).output_tokens
    eng = engines[2]
    runner, joins = _greedy(RUNNER), _greedy(JOINS)
    kinds = []
    with torch.inference_mode():
        eng.waiting.put(runner)
        eng._admit()
        eng._complete_round(eng._dispatch_round())
        eng.waiting.put(joins)
        eng._admit()
        while any(r.finished_s is None and r.error is None for r in (runner, joins)):
            handle = eng._dispatch_round()
            kinds.append(handle[0])
            eng._complete_round(handle)
    eng.stop()
    out["mixed"] = (runner.output_tokens, joins.output_tokens, runner.error, joins.error)
    out["mixed_kinds"] = kinds
    return out


def _rank_main(rank, tree):
    torch.set_num_threads(1)
    cfg = tconfig.tiny_config(**TINY)
    proc = ChatTSProcessor(FakeTokenizer(vocab_limit=200), cfg)
    whole = from_jax_params(tree, cfg, "cpu")
    mesh = tmesh.create_mesh(tp=2)
    model = sharding.place_params(mesh, cfg, whole, device="cpu")
    out = {"generate": InferenceEngine(model, cfg, device="cpu", cache_dtype=torch.float32)
           .generate(proc(*BATCH), GenerationConfig(max_new_tokens=6, greedy=True)).token_ids}
    engines = [_engine(model, cfg, proc, kw) for kw in ENGINES]
    if mesh.is_driver:
        out.update(_drive(engines))
    else:
        for method in ("start", "submit"):
            try:
                getattr(engines[0], method)(*([_greedy(PLAIN)] if method == "submit" else []))
                out[method] = None
            except RuntimeError as err:
                out[method] = str(err)
        for eng in engines:
            eng.follow()
        out["followed"] = True
    # dp = 2: world rank 0 drives both replicas.
    dp_mesh = tmesh.create_mesh(dp=2, tp=1)
    replica = sharding.place_params(dp_mesh, cfg, whole, device="cpu")
    engines = [_engine(replica, cfg, proc, kw) for kw in (ENGINES[0], ENGINES[2])]
    out["dp2_driver"] = engines[0].is_driver
    if engines[0].is_driver:
        with engines[0] as eng:
            out["dp2"] = eng.generate_sync(*PLAIN[:2], _greedy(PLAIN).params,
                                           timeout=WORLD_TIMEOUT_S).output_tokens
        runner, joins = _greedy(RUNNER), _greedy(JOINS)
        eng = engines[1]
        with torch.inference_mode():
            eng.waiting.put(runner)
            eng._admit()
            eng._complete_round(eng._dispatch_round())
            eng.waiting.put(joins)
            eng._admit()
            while any(r.finished_s is None and r.error is None for r in (runner, joins)):
                eng._complete_round(eng._dispatch_round())
        eng.stop()
        out["dp2_mixed"] = (runner.output_tokens, joins.output_tokens)
    else:
        for eng in engines:
            eng.follow()
        out["dp2"] = "followed"
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax

    from chatts_tpu.core import config as jconfig
    from chatts_tpu.models import chatts

    params = chatts.init_params(jconfig.tiny_config(**TINY), jax.random.PRNGKey(0),
                                dtype=jax.numpy.float32)
    tree = jax.tree.map(np.asarray, params)
    # The world runs while this process computes JAX's tokens.
    box = []

    def run():
        try:
            box.append(distributed.run_world(
                _rank_main, 2, (tree,), backend="gloo", timeout_s=WORLD_TIMEOUT_S,
                store_dir=str(tmp_path_factory.mktemp("tp_serve"))))
        except BaseException as err:  # re-raised below
            box.append(err)

    thread = threading.Thread(target=run)
    thread.start()
    want = {"generate": _jax_tokens(params, None, batch=BATCH),
            "plain": _jax_tokens(params, PLAIN), "long": _jax_tokens(params, LONG),
            "int8": _jax_tokens(params, PLAIN, "int8"),
            "runner": _jax_tokens(params, RUNNER), "joins": _jax_tokens(params, JOINS)}
    thread.join()
    if isinstance(box[0], BaseException):
        raise box[0]
    return dict(results=box[0], want=want)


def _jax_tokens(params, spec, cache="f32", batch=None):
    import jax.numpy as jnp

    from chatts_tpu.core import config as jconfig
    from chatts_tpu.processor import processor as jprocessor
    from chatts_tpu.runtime.engine import InferenceEngine as JaxEngine

    jcfg = jconfig.tiny_config(**TINY)
    jproc = jprocessor.ChatTSProcessor(FakeTokenizer(vocab_limit=200), jcfg)
    engine = JaxEngine(params, jcfg, cache_dtype={"f32": jnp.float32, "int8": jnp.int8}[cache],
                       attn_impl="xla", decode_recent_kv=False, decode_chunk=4, fuse=False)
    if batch is not None:
        return engine.generate(jproc(*batch), jconfig.GenerationConfig(
            max_new_tokens=6, greedy=True)).token_ids
    prompt, series, n = spec
    return engine.generate(jproc([prompt], series), jconfig.GenerationConfig(
        max_new_tokens=n, greedy=True)).token_ids[0]


def test_torch_tp2_generate_matches_jax(world):
    want = world["want"]["generate"]
    assert [r["generate"] for r in world["results"]] == [want, want]


@pytest.mark.parametrize("case", ["plain", "long", "int8", "http"])
def test_torch_tp2_serve_matches_jax(world, case):
    driver = world["results"][0]
    assert driver[case] == world["want"]["plain" if case == "http" else case]
    if case == "long":
        # The long prompt (above prefill_chunk) took the scan-sliced path.
        assert "mixed" in driver["long_kinds"], driver["long_kinds"]


def test_torch_dp2_serve_matches_jax(world):
    driver = world["results"][0]
    assert driver["dp2"] == world["want"]["plain"]
    runner, joins = driver["dp2_mixed"]
    assert runner == world["want"]["runner"]
    assert joins == world["want"]["joins"]


def test_torch_tp2_serve_mixed_admission_while_decoding(world):
    runner, joins, runner_err, joins_err = world["results"][0]["mixed"]
    assert runner_err is None and joins_err is None
    assert "mixed" in world["results"][0]["mixed_kinds"]
    assert runner == world["want"]["runner"]
    assert joins == world["want"]["joins"]


def test_torch_tp2_serve_roles_and_refusals(world):
    driver, follower = world["results"]
    assert follower["followed"] is True
    assert "follow()" in follower["start"] and "tp rank 0" in follower["submit"]
    # dp = 2 is served, not refused: world rank 0 drives, the other dp
    # group's rank follows.
    assert [res["dp2_driver"] for res in world["results"]] == [True, False]
    assert follower["dp2"] == "followed"
    stats = driver["stats"]
    assert stats["decode_graph"] is False and stats["loop_error"] is None
    assert stats["eager_decode_reason"] == "no CUDA graphs off the card"
