"""Tensor parallelism in the port (``chatts_tpu_torch/parallel/``) against
the JAX package, on real ``gloo`` worlds of CPU processes.

One world of 4 ranks (``run_world``, a ``file://`` store under the test's
temporary directory, no TCP port) runs every case of this module once and
returns each rank's results; the tests compare them with the JAX package in
this process.  The ranks import nothing of JAX.

- Greedy tokens of ``InferenceEngine`` on a model placed at tp = 4 and at
  dp = 2 x tp = 2 equal JAX's single-device ``InferenceEngine`` exactly
  (the tiny f32 model of ``tests/test_multichip_inference.py``); so do
  those of a model with 2 kv heads at tp = 4, whose attention the port
  replicates (``parallel/sharding.py``: tp must divide the heads).
- The ``_tp`` kernel wrappers, each rank on its shard, gathered, equal
  JAX's ``_tp`` wrappers (interpret mode on the 8 virtual CPU devices)
  within 1e-5 in f32.
- ``load_checkpoint(mesh=)`` gives tensors bit-equal to ``place_params`` of
  the whole load: symmetric, asymmetric and activation-order GPTQ
  directories (built as ``tests/test_torch_gptq.py`` builds its tensors),
  and a float checkpoint quantized to 4 and 8 bits or kept float.
- ``act_int8`` on a shard: int4 layers, replicated ones too, ignore it as
  JAX's do under a mesh; int8 layers take it over whole rows.
- ``maybe_fuse`` leaves a sharded model unfused; ``shard_indices``,
  ``sanitize_spec`` and the kernels' ``supported_tp`` rules equal JAX's.

The world's join is bounded (60 s): a hung rank fails the module's tests
and every rank is killed."""
import json
import os
import threading
import types

import numpy as np
import pytest
import torch

from chatts_tpu_torch.core import config as tconfig
from chatts_tpu_torch.core.config import GenerationConfig
from chatts_tpu_torch.models import chatts as tchatts
from chatts_tpu_torch.models.convert import from_jax_params
from chatts_tpu_torch.parallel import distributed, sharding
from chatts_tpu_torch.parallel import mesh as tmesh
from chatts_tpu_torch.processor.processor import ChatTSProcessor
from chatts_tpu_torch.runtime.engine import InferenceEngine
from tests.helpers import FakeTokenizer

WORLD_TIMEOUT_S = 60

# tests/test_multichip_inference.py:19-27
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=8, num_key_value_heads=4, patch_size=4,
            max_sequence_length=64, ts_token_start_index=240)
TINY_KV2 = dict(TINY, num_key_value_heads=2)
# The Qwen3 decoder: qk_norm, no attention bias.
TINY_QWEN3 = dict(TINY, qwen3=True)
CONFIGS = {"TINY": TINY, "TINY_KV2": TINY_KV2, "TINY_QWEN3": TINY_QWEN3}
BATCH2 = (["analyze <ts><ts/> now", "and <ts><ts/> too"],
          [np.arange(12.0), np.sin(np.arange(8.0))])
BATCH4 = (["one <ts><ts/>", "two <ts><ts/>", "three <ts><ts/>", "four <ts><ts/>"],
          [np.arange(8.0) * (i + 1) for i in range(4)])
# (config, batch, new tokens, dp, tp) of each generate case.
GENERATE = {
    "tp4": ("TINY", "BATCH2", 6, 1, 4),
    "dp2_tp2": ("TINY", "BATCH4", 4, 2, 2),
    "kv2_tp4": ("TINY_KV2", "BATCH2", 6, 1, 4),
    "qwen3_dp2_tp2": ("TINY_QWEN3", "BATCH4", 4, 2, 2),
}
# The GPTQ directories: widths that tile B3 (head_dim 128), 2 heads and 2 kv
# heads, so tp = 2 shards the attention and tp = 4 replicates it.
GPTQ_DIMS = dict(hidden=256, inter=512, heads=2, kv_heads=2, head_dim=128, vocab=1024)
LOAD_STYLES = ("sym", "asym", "desc_act", "float")
# Decode attention inputs (rows, heads, kv heads, capacity) and lengths.
RDA = dict(b=4, h=8, kvh=4, d=128, s=512, lengths=[512, 300, 1, 17])
INT4 = dict(r=5, in_dim=512, out_dim=512)


def _config(name):
    return tconfig.tiny_config(**CONFIGS[name])


def _batch(proc, name):
    texts, series = {"BATCH2": BATCH2, "BATCH4": BATCH4}[name]
    return proc(list(texts), list(series))


# ---------------------------------------------------------------------------
# Inputs, made in this process
# ---------------------------------------------------------------------------

def _jax_params(name, seed=0):
    import jax
    import jax.numpy as jnp

    from chatts_tpu.core import config as jconfig
    from chatts_tpu.models import chatts

    params = chatts.init_params(jconfig.tiny_config(**CONFIGS[name]), jax.random.PRNGKey(seed),
                                dtype=jnp.float32)
    if CONFIGS[name].get("qwen3"):
        # Norm weights of ones would not show one skipped or misapplied.
        rng = np.random.default_rng(seed)
        for layer in params["llm"]["layers"]:
            for norm in ("q_norm", "k_norm"):
                attn = layer["self_attn"]
                attn[norm] = jnp.asarray(rng.uniform(0.5, 1.5, attn[norm].shape), jnp.float32)
    return params


def write_gptq_dir(path, style, seed=0):
    """A one-layer Qwen2 ChatTS checkpoint: GPTQ-Int4 projections (symmetric,
    asymmetric zero-points or a shuffled ``g_idx``) or, for "float", f32
    weights; fp16 embedding and head, f32 encoder."""
    from chatts_tpu_torch.models import gptq
    from chatts_tpu_torch.utils.safetensors_io import save_file

    g = GPTQ_DIMS
    rng = np.random.default_rng(seed)
    hid, inter, vocab = g["hidden"], g["inter"], g["vocab"]
    qd, kvd = g["heads"] * g["head_dim"], g["kv_heads"] * g["head_dim"]
    tensors = {}

    def linear(key, in_dim, out_dim):
        if style == "float":
            tensors[key + ".weight"] = rng.normal(0, in_dim ** -0.5, (out_dim, in_dim)).astype(
                np.float32)
            return
        groups = in_dim // 128
        codes = rng.integers(0, 16, size=(in_dim, out_dim), dtype=np.int32)
        zeros = (rng.integers(5, 12, size=(groups, out_dim), dtype=np.int32) if style == "asym"
                 else np.full((groups, out_dim), 8, np.int32))
        tensors[key + ".qweight"] = gptq.pack_int4(codes, axis=0)
        tensors[key + ".qzeros"] = gptq.pack_int4(zeros - 1, axis=1)
        tensors[key + ".scales"] = (rng.uniform(0.5, 1.5, (groups, out_dim))
                                    * 0.2 / np.sqrt(in_dim)).astype(np.float16)
        g_idx = np.repeat(np.arange(groups), 128).astype(np.int32)
        if style == "desc_act":
            rng.shuffle(g_idx)
        tensors[key + ".g_idx"] = g_idx

    tensors["model.embed_tokens.weight"] = rng.normal(0, 0.02, (vocab, hid)).astype(np.float16)
    tensors["model.norm.weight"] = np.ones(hid, np.float16)
    tensors["lm_head.weight"] = rng.normal(0, hid ** -0.5, (vocab, hid)).astype(np.float16)
    p = "model.layers.0."
    tensors[p + "input_layernorm.weight"] = np.ones(hid, np.float16)
    tensors[p + "post_attention_layernorm.weight"] = np.ones(hid, np.float16)
    for name, out_dim in (("q_proj", qd), ("k_proj", kvd), ("v_proj", kvd)):
        linear(p + "self_attn." + name, hid, out_dim)
        tensors[p + "self_attn." + name + ".bias"] = rng.normal(0, 0.02, out_dim).astype(
            np.float16)
    linear(p + "self_attn.o_proj", qd, hid)
    linear(p + "mlp.gate_proj", hid, inter)
    linear(p + "mlp.up_proj", hid, inter)
    linear(p + "mlp.down_proj", inter, hid)
    config = dict(architectures=["Qwen2TSForCausalLM"], model_type="qwen2_ts",
                  vocab_size=vocab, hidden_size=hid, intermediate_size=inter,
                  num_hidden_layers=1, num_attention_heads=g["heads"],
                  num_key_value_heads=g["kv_heads"], head_dim=g["head_dim"],
                  rms_norm_eps=1e-6, rope_theta=1e6, max_position_embeddings=4096,
                  tie_word_embeddings=False,
                  ts={"patch_size": 8, "num_layers": 2, "hidden_size": hid, "num_features": 2,
                      "max_sequence_length": 256},
                  ts_token_start_index=vocab - 10)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    cfg = tconfig.ChatTSConfig.from_pretrained(path)
    sizes = [cfg.ts.mlp_input_size] + [hid] * cfg.ts.num_layers
    for i in range(cfg.ts.num_layers):
        tensors[f"ts_encoder.mlp.{2 * i}.weight"] = rng.normal(
            0, 0.1, (sizes[i + 1], sizes[i])).astype(np.float32)
        tensors[f"ts_encoder.mlp.{2 * i}.bias"] = np.zeros(sizes[i + 1], np.float32)
    save_file(tensors, os.path.join(path, "model.safetensors"))


def _kernel_inputs():
    rng = np.random.default_rng(5)
    r = RDA
    q = rng.normal(0, 1, (r["b"], r["h"], r["d"])).astype(np.float32)
    k = rng.normal(0, 1, (r["b"], r["kvh"], r["s"], r["d"])).astype(np.float32)
    v = rng.normal(0, 1, (r["b"], r["kvh"], r["s"], r["d"])).astype(np.float32)
    i = INT4
    x = rng.normal(0, 1, (i["r"], i["in_dim"])).astype(np.float32)
    w = rng.normal(0, i["in_dim"] ** -0.5, (i["in_dim"], i["out_dim"])).astype(np.float32)
    return dict(q=q, k=k, v=v, lengths=np.asarray(r["lengths"], np.int32), x=x, w=w)


# ---------------------------------------------------------------------------
# The ranks (no JAX here)
# ---------------------------------------------------------------------------

def _fields(model):
    return {name: t.detach().clone() for name, t in
            list(model.named_parameters()) + list(model.named_buffers())}


def _layout(model):
    """What a rank holds: heads, kinds and shapes of layer 0, the vocab."""
    layer = model.llm.layers[0]
    attn, mlp = layer.self_attn, layer.mlp
    return dict(heads=attn.num_heads, kv_heads=attn.num_kv_heads, attn_mesh=attn.mesh is not None,
                q_kind=attn.q_proj.tp_kind, o_kind=attn.o_proj.tp_kind,
                gate_kind=mlp.gate_proj.tp_kind, down_kind=mlp.down_proj.tp_kind,
                gate_out=mlp.gate_proj.out_features, down_in=mlp.down_proj.in_features,
                vocab_rows=model.llm.embed_tokens.shape[0], vocab_start=model.llm.vocab_start,
                fused=attn.qkv_proj is not None)


def _generate_cases(trees, meshes):
    out = {}
    for case, (cfg_name, batch_name, n_new, dp, tp) in GENERATE.items():
        cfg = _config(cfg_name)
        proc = ChatTSProcessor(FakeTokenizer(vocab_limit=200), cfg)
        # place_params takes a whole port model or, for tp4, the JAX tree.
        whole = trees[cfg_name] if case == "tp4" else from_jax_params(trees[cfg_name], cfg, "cpu")
        model = sharding.place_params(meshes[(dp, tp)], cfg, whole, device="cpu")
        engine = InferenceEngine(model, cfg, device="cpu", cache_dtype=torch.float32)
        res = engine.generate(_batch(proc, batch_name),
                              GenerationConfig(max_new_tokens=n_new, greedy=True))
        out[case] = dict(tokens=res.token_ids, layout=_layout(engine.model),
                         unfused=tchatts.maybe_fuse(model).llm.layers[0].self_attn.qkv_proj is None)
    return out


def _kernel_cases(inputs, meshes):
    from chatts_tpu_torch.models.qwen import quantize_kv
    from chatts_tpu_torch.ops import int4_matmul as i4
    from chatts_tpu_torch.ops import ragged_decode_attention as rda

    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    out = {}
    for dp, tp in ((1, 4), (2, 2)):
        mesh = meshes[(dp, tp)]
        rows = slice(*sharding.dp_rows(mesh, RDA["b"]))
        heads = slice(*sharding.shard_range(RDA["h"], mesh))
        kv = slice(*sharding.shard_range(RDA["kvh"], mesh))
        q, k, v = t["q"][rows, heads], t["k"][rows, kv], t["v"][rows, kv]
        lengths = t["lengths"][rows]
        bf = rda.ragged_decode_attention_tp(q.contiguous(), k.contiguous(), v.contiguous(),
                                            lengths, mesh=mesh)
        kq, ks = quantize_kv(t["k"])
        vq, vs = quantize_kv(t["v"])
        i8 = rda.ragged_decode_attention_int8_tp(
            q.contiguous(), kq[rows, kv].contiguous(), vq[rows, kv].contiguous(),
            ks[rows, kv].contiguous(), vs[rows, kv].contiguous(), lengths, mesh=mesh)
        out[("rda", dp, tp)] = (mesh.dp_index, mesh.tp_index, bf.numpy(), i8.numpy())
    mesh = meshes[(1, 4)]
    packed, scales = i4.pack_int4(t["w"])
    cols = sharding.column_index([INT4["out_dim"]], mesh)
    col = i4.int4_matmul_tp(t["x"], packed[:, cols].contiguous(), scales[:, cols].contiguous(),
                            mesh=mesh, kind="col")
    i0, i1 = sharding.shard_range(INT4["in_dim"], mesh)
    g0, g1 = sharding.shard_range(INT4["in_dim"] // 128, mesh)
    row = i4.int4_matmul_tp(t["x"][:, i0:i1].contiguous(), packed[i0 // 2:i1 // 2].contiguous(),
                            scales[g0:g1].contiguous(), mesh=mesh, kind="row")
    out["int4"] = (mesh.tp_index, col.numpy(), row.numpy(), packed.numpy(), scales.numpy())
    return out


def _load_cases(dirs, meshes):
    from chatts_tpu_torch.models import weights

    out = {}
    for style in LOAD_STYLES:
        for bits in ((4, 8, None) if style == "float" else (4,)):
            for dp, tp in ((2, 2), (1, 4)):
                mesh = meshes[(dp, tp)]
                cfg, whole = weights.load_checkpoint(dirs[style], quantize_bits=bits,
                                                     device="cpu", dtype=torch.float32)
                placed = sharding.place_params(mesh, cfg, whole, device="cpu")
                _, loaded = weights.load_checkpoint(dirs[style], quantize_bits=bits,
                                                    device="cpu", dtype=torch.float32, mesh=mesh)
                a, b = _fields(placed), _fields(loaded)
                differ = sorted(name for name in set(a) | set(b)
                                if name not in a or name not in b or a[name].dtype != b[name].dtype
                                or not torch.equal(a[name], b[name]))
                # The loaded shard runs, and gives the whole model's logits.
                ids = torch.arange(8)[None] * 97 % GPTQ_DIMS["vocab"]
                pos = torch.arange(8)[None]
                with torch.inference_mode():
                    got = loaded.compute_logits(loaded(ids, pos)[0])
                    want = whole.compute_logits(whole(ids, pos)[0])
                    got_a8 = loaded.compute_logits(loaded(ids, pos, act_int8=True)[0])
                    want_a8 = whole.compute_logits(whole(ids, pos, act_int8=True)[0])
                # Under a mesh JAX's int4 layers, replicated ones too, ignore
                # act_int8 and its int8 layers take it.
                a8_want = want_a8 if bits == 8 else want
                fmt = {n: (None if getattr(loaded.llm.layers[0].mlp.down_proj, n) is None else
                           tuple(getattr(loaded.llm.layers[0].mlp.down_proj, n).shape))
                       for n in ("kernel_q4", "zeros4", "perm4", "kernel_q", "kernel")}
                out[(style, bits, dp, tp)] = dict(
                    differ=differ, fields=len(a), layout=_layout(loaded), down=fmt,
                    logit_err=float((got - want).abs().max()),
                    logit_max=float(want.abs().max()),
                    a8_err=float((got_a8 - a8_want).abs().max()),
                    a8_gap=float((want_a8 - want).abs().max()))
    return out


def _rank_main(rank, trees, kernel_inputs, dirs):
    torch.set_num_threads(1)
    meshes = {(1, 4): tmesh.create_mesh(dp=1, tp=4), (2, 2): tmesh.create_mesh(dp=2, tp=2)}
    return dict(generate=_generate_cases(trees, meshes),
                kernels=_kernel_cases(kernel_inputs, meshes),
                load=_load_cases(dirs, meshes),
                process_info=distributed.process_info(),
                shard_indices=list(distributed.shard_indices(10)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax

    root = tmp_path_factory.mktemp("tp_world")
    trees = {name: jax.tree.map(np.asarray, _jax_params(name)) for name in CONFIGS}
    dirs = {}
    for style in LOAD_STYLES:
        dirs[style] = str(root / style)
        write_gptq_dir(dirs[style], style)
    kernel_inputs = _kernel_inputs()
    # The world runs while this process computes JAX's tokens.
    box = []
    thread = threading.Thread(target=lambda: box.append(_run(
        distributed.run_world, _rank_main, 4, (trees, kernel_inputs, dirs), backend="gloo",
        timeout_s=WORLD_TIMEOUT_S, store_dir=str(root))))
    thread.start()
    jax_tokens = {case: _jax_generate(*GENERATE[case][:3]) for case in GENERATE}
    thread.join()
    if isinstance(box[0], BaseException):
        raise box[0]
    return dict(results=box[0], trees=trees, inputs=kernel_inputs, jax_tokens=jax_tokens)


def _run(fn, *args, **kw):
    """fn's result, or the exception it raised."""
    try:
        return fn(*args, **kw)
    except BaseException as err:  # re-raised by the fixture
        return err


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

def _jax_generate(cfg_name, batch_name, n_new):
    import jax.numpy as jnp

    from chatts_tpu.core import config as jconfig
    from chatts_tpu.processor import processor as jprocessor
    from chatts_tpu.runtime.engine import InferenceEngine as JaxEngine

    jcfg = jconfig.tiny_config(**CONFIGS[cfg_name])
    jproc = jprocessor.ChatTSProcessor(FakeTokenizer(vocab_limit=200), jcfg)
    texts, series = {"BATCH2": BATCH2, "BATCH4": BATCH4}[batch_name]
    engine = JaxEngine(_jax_params(cfg_name), jcfg, cache_dtype=jnp.float32, attn_impl="xla",
                       decode_recent_kv=False, fuse=False)
    return engine.generate(jproc(list(texts), list(series)),
                           jconfig.GenerationConfig(max_new_tokens=n_new, greedy=True)).token_ids


@pytest.mark.parametrize("case", sorted(GENERATE))
def test_torch_tp_generate_matches_jax_single_device(world, case):
    want = world["jax_tokens"][case]
    for rank, res in enumerate(world["results"]):
        assert res["generate"][case]["tokens"] == want, (case, rank)


def test_torch_tp_layout_of_each_case(world):
    layouts = [r["generate"] for r in world["results"]]
    tp4 = layouts[1]["tp4"]["layout"]
    assert tp4 == dict(heads=2, kv_heads=1, attn_mesh=True, q_kind="col", o_kind="row",
                       gate_kind="col", down_kind="row", gate_out=32, down_in=32,
                       vocab_rows=64, vocab_start=64, fused=False)
    dp2 = layouts[3]["dp2_tp2"]["layout"]
    assert (dp2["heads"], dp2["kv_heads"], dp2["gate_out"], dp2["vocab_start"]) == (4, 2, 64, 128)
    # 2 kv heads over tp = 4: the attention is replicated whole, the MLP and
    # the vocabulary still shard.
    kv2 = layouts[2]["kv2_tp4"]["layout"]
    assert (kv2["heads"], kv2["kv_heads"], kv2["attn_mesh"], kv2["q_kind"], kv2["o_kind"]) == (
        8, 2, False, "", "")
    assert (kv2["gate_kind"], kv2["gate_out"], kv2["vocab_rows"]) == ("col", 32, 64)


def test_torch_tp_maybe_fuse_leaves_a_sharded_model_unfused(world):
    assert all(r["generate"][case]["unfused"] for r in world["results"] for case in GENERATE)
    # The same model, unsharded, does fuse.
    cfg = _config("TINY")
    model = tchatts.maybe_fuse(from_jax_params(world["trees"]["TINY"], cfg, "cpu"))
    assert model.llm.layers[0].self_attn.qkv_proj is not None


def test_torch_tp_process_info_and_shard_indices(world):
    from chatts_tpu.parallel import distributed as jdist

    for rank, res in enumerate(world["results"]):
        assert res["process_info"] == (rank, 4)
        assert res["shard_indices"] == list(jdist.shard_indices(10, rank, 4))
    assert distributed.process_info() == (0, 1)


def _jax_mesh(dp, tp):
    import jax

    from chatts_tpu.parallel import mesh as jmesh

    return jmesh.create_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])


@pytest.mark.parametrize("dp,tp", [(1, 4), (2, 2)])
def test_torch_tp_decode_attention_wrappers_match_jax(world, dp, tp):
    import jax.numpy as jnp

    from chatts_tpu.models.qwen import _quantize_kv
    from chatts_tpu.ops import ragged_decode_attention as jrda

    x = world["inputs"]
    mesh = _jax_mesh(dp, tp)
    q, k, v, lengths = (jnp.asarray(x[n]) for n in ("q", "k", "v", "lengths"))
    want_bf = np.asarray(jrda.ragged_decode_attention_tp(q, k, v, lengths, mesh=mesh,
                                                         interpret=True))
    kq, ks = _quantize_kv(k)
    vq, vs = _quantize_kv(v)
    want_i8 = np.asarray(jrda.ragged_decode_attention_int8_tp(q, kq, vq, ks, vs, lengths,
                                                              mesh=mesh, interpret=True))
    got_bf, got_i8 = np.zeros_like(want_bf), np.zeros_like(want_i8)
    part_b, part_h = RDA["b"] // dp, RDA["h"] // tp
    for res in world["results"]:
        di, ti, bf, i8 = res["kernels"][("rda", dp, tp)]
        rows = slice(di * part_b, (di + 1) * part_b)
        heads = slice(ti * part_h, (ti + 1) * part_h)
        got_bf[rows, heads], got_i8[rows, heads] = bf, i8
    np.testing.assert_allclose(got_bf, want_bf, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_i8, want_i8, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["col", "row"])
def test_torch_tp_int4_matmul_wrapper_matches_jax(world, kind):
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from chatts_tpu.ops import int4_matmul as ji4

    results = world["results"]
    packed, scales = results[0]["kernels"]["int4"][3:]
    mesh = _jax_mesh(1, 4)
    specs = {"col": (PartitionSpec(None, "tp"), PartitionSpec(None, "tp")),
             "row": (PartitionSpec("tp", None), PartitionSpec("tp", None))}[kind]
    import jax

    jp = jax.device_put(jnp.asarray(packed), NamedSharding(mesh, specs[0]))
    js = jax.device_put(jnp.asarray(scales), NamedSharding(mesh, specs[1]))
    want = np.asarray(ji4.int4_matmul_tp(jnp.asarray(world["inputs"]["x"]), jp, js, mesh=mesh,
                                         kind=kind, interpret=True))
    if kind == "col":
        got = np.concatenate([r["kernels"]["int4"][1] for r in results], axis=1)
    else:
        got = results[0]["kernels"]["int4"][2]
        for r in results[1:]:  # every rank holds the whole sum
            np.testing.assert_array_equal(r["kernels"]["int4"][2], got)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("style,bits", [("sym", 4), ("asym", 4), ("desc_act", 4), ("float", 4),
                                        ("float", 8), ("float", None)])
@pytest.mark.parametrize("dp,tp", [(2, 2), (1, 4)])
def test_torch_tp_sharded_load_bit_equal_to_sliced_whole_load(world, style, bits, dp, tp):
    for rank, res in enumerate(world["results"]):
        got = res["load"][(style, bits, dp, tp)]
        assert got["differ"] == [], (rank, got["differ"])
        assert got["fields"] >= 19
        assert got["logit_err"] <= 1e-5 * got["logit_max"], got
        layout = got["layout"]
        # tp = 2 shards the 2 heads, tp = 4 replicates them; the MLP and
        # the 1,024-token vocabulary shard at both.
        assert layout["attn_mesh"] == (tp == 2)
        assert layout["down_kind"] == "row" and layout["down_in"] == GPTQ_DIMS["inter"] // tp
        assert layout["vocab_rows"] == GPTQ_DIMS["vocab"] // tp
        down = got["down"]
        if bits == 4:
            assert down["kernel_q4"] == (GPTQ_DIMS["inter"] // tp // 2, GPTQ_DIMS["hidden"])
        assert (down["zeros4"] is not None) == (style == "asym")
        assert down["perm4"] == ((GPTQ_DIMS["inter"] // tp,) if style == "desc_act" else None)
        assert (down["kernel_q"] is not None) == (bits == 8)


@pytest.mark.parametrize("style,bits", [("sym", 4), ("asym", 4), ("desc_act", 4), ("float", 4),
                                        ("float", 8)])
@pytest.mark.parametrize("dp,tp", [(2, 2), (1, 4)])
def test_torch_tp_prefill_act_int8_as_jax_under_a_mesh(world, style, bits, dp, tp):
    """``act_int8`` on a sharded model: int4 layers ignore it, as JAX's
    ``_dense`` takes its a8 kernel only without a mesh, so the shard's
    logits are the whole model's without it, also at tp = 4, where the
    attention is replicated; int8 layers quantize their rows over the whole
    row, so the shard's logits are the whole model's with it."""
    for rank, res in enumerate(world["results"]):
        got = res["load"][(style, bits, dp, tp)]
        assert got["a8_err"] <= 1e-5 * got["logit_max"], (rank, got)
        # act_int8 moves the whole model's logits far beyond that.
        assert got["a8_gap"] > 1e-3 * got["logit_max"], (rank, got)


def test_torch_tp_sanitize_spec_matches_jax():
    from chatts_tpu.parallel import sharding as jsharding

    specs = [(None, "tp"), ("tp", None), ("dp", "tp", None, None), ("tp",), (),
             (("dp", "tp"), None)]
    shapes = [(64, 32), (12, 8), (4, 2, 16, 8), (6,), (5, 5), (8, 3)]
    for dp, tp in ((1, 4), (2, 2), (2, 4), (1, 8)):
        fake = types.SimpleNamespace(shape={"dp": dp, "tp": tp})
        jmesh = _jax_mesh(dp, tp)
        for spec in specs:
            for shape in shapes:
                if len(spec) > len(shape):
                    continue
                want = tuple(jsharding.sanitize_spec(jsharding.P(*spec), shape, jmesh))
                assert sharding.sanitize_spec(spec, shape, fake) == want, (spec, shape, dp, tp)


def test_torch_tp_spec_tables_match_jax():
    from chatts_tpu.parallel import sharding as jsharding

    jcfg = types.SimpleNamespace(ts=types.SimpleNamespace(num_layers=3),
                                 llm=types.SimpleNamespace(num_hidden_layers=2))

    def plain(tree):
        if isinstance(tree, dict):
            return {k: plain(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [plain(v) for v in tree]
        return tuple(tree)

    assert plain(jsharding.chatts_param_specs(jcfg)) == sharding.chatts_param_specs(jcfg)
    assert plain(jsharding.batch_specs()) == sharding.batch_specs()
    assert [tuple(map(tuple, layer)) for layer in jsharding.kv_cache_specs(3)] == [
        tuple(layer) for layer in sharding.kv_cache_specs(3)]


def test_torch_tp_supported_rules_hold_jax_and_the_kernels():
    from chatts_tpu.ops import int4_matmul as ji4
    from chatts_tpu.ops import ragged_decode_attention as jrda
    from chatts_tpu_torch.ops import int4_matmul as i4
    from chatts_tpu_torch.ops import ragged_decode_attention as rda

    for dp, tp in ((1, 2), (2, 2), (1, 4), (1, 8)):
        jmesh = _jax_mesh(dp, tp)
        fake = types.SimpleNamespace(shape={"dp": dp, "tp": tp})
        for b, kvh, h in ((4, 4, 8), (2, 8, 40), (3, 2, 8), (8, 1, 32), (8, 4, 80)):
            got = rda.supported_tp(fake, b, kvh, h)
            # The port takes a subset of JAX's cases: at most 16 heads a kv head.
            assert got == (jrda.supported_tp(jmesh, b, kvh, h) and h // kvh <= rda.MAX_GROUP)
        for in_dim, out_dim, kind in ((5120, 7168, "col"), (5120, 1024, "col"),
                                      (13824, 5120, "row"), (256, 384, "col"), (384, 256, "row"),
                                      (512, 256, "row"), (6912, 5120, "row")):
            got = i4.supported_tp(fake, in_dim, out_dim, 128, kind)
            if got:  # every shard the port takes, JAX takes, and B3 tiles
                assert ji4.supported_tp(jmesh, in_dim, out_dim, 128, kind)
                local = (in_dim, out_dim // tp) if kind == "col" else (in_dim // tp, out_dim)
                assert local[0] % 128 == 0 and local[1] % 128 == 0
    # ChatTS-14B at tp = 2 and 4: every projection tiles (unfused q, k, v, o,
    # gate, up, down, and the head).
    for tp in (2, 4):
        fake = types.SimpleNamespace(shape={"dp": 1, "tp": tp})
        for in_dim, out_dim, kind in ((5120, 5120, "col"), (5120, 1024, "col"),
                                      (5120, 5120, "row"), (5120, 13824, "col"),
                                      (13824, 5120, "row"), (5120, 152064, "col")):
            assert i4.supported_tp(fake, in_dim, out_dim, 128, kind), (in_dim, out_dim, kind, tp)


def test_torch_tp_placing_for_the_card_refuses_shards_b3_cannot_tile():
    from torch import nn

    from chatts_tpu_torch.models.qwen import Dense

    fake = types.SimpleNamespace(shape={"dp": 1, "tp": 2}, tp=2)

    def shard(out_cols, kind="col"):
        layer = Dense(kernel_q4=torch.zeros((128, out_cols), dtype=torch.int8),
                      scales4=torch.ones((2, out_cols)), mesh=fake, tp_kind=kind)
        return nn.ModuleDict({"proj": layer})

    sharding.check_kernel_shapes(shard(128), "cuda")  # (256, 256) over tp 2: 128 a rank
    sharding.check_kernel_shapes(shard(64), "cpu")  # the plain version takes any shape
    with pytest.raises(ValueError, match="does not tile for int4_matmul"):
        sharding.check_kernel_shapes(shard(64), "cuda")  # 64 columns a rank
    sharding.check_kernel_shapes(shard(128, "row"), "cuda")  # IN 512 over tp 2: 256 a rank
    with pytest.raises(ValueError, match="does not tile"):
        sharding.check_kernel_shapes(shard(64, "row"), "cuda")  # OUT 64


def test_torch_tp_create_mesh_without_a_world():
    assert tmesh.create_mesh() is None
    assert tmesh.create_mesh(dp=1, tp=1) is None
    with pytest.raises(ValueError, match="dp\\*tp"):
        tmesh.create_mesh(dp=2, tp=2)
    # Every collective is the identity without a mesh.
    x = torch.arange(6.0).reshape(2, 3)
    assert tmesh.all_reduce_tp(None, x) is x and tmesh.all_gather_tp(None, x) is x
    assert tmesh.broadcast_from_driver(None, ("plan", 1)) == ("plan", 1)
    assert sharding.infer_mesh(from_jax_params(
        __import__("jax").tree.map(np.asarray, _jax_params("TINY")), _config("TINY"),
        "cpu")) is None


def test_torch_tp_init_multihost_reads_arguments_and_environment(monkeypatch):
    calls = []
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    distributed.init_multihost("10.0.0.1:1234", 4, 0, backend="gloo")
    monkeypatch.setenv("COORDINATOR_ADDRESS", "file:///tmp/store")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.setenv("PROCESS_ID", "1")
    distributed.init_multihost()
    assert calls[0] == ("gloo", dict(init_method="tcp://10.0.0.1:1234", world_size=4, rank=0))
    assert calls[1][0] == "nccl"  # the default backend, never switched on its own
    assert calls[1][1]["init_method"] == "file:///tmp/store"
    assert (calls[1][1]["world_size"], calls[1][1]["rank"]) == (2, 1)


def _hang(rank):
    import time

    if rank == 1:
        time.sleep(600)
    return rank


def _fail(rank):
    if rank == 1:
        raise RuntimeError("rank 1 gives up")
    return rank


def test_torch_tp_run_world_fails_a_failed_or_hung_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        distributed.run_world(_fail, 2, backend="gloo", timeout_s=30,
                              store_dir=str(tmp_path / "fail"))
    os.makedirs(tmp_path / "hang")
    with pytest.raises(RuntimeError, match="outlived"):
        distributed.run_world(_hang, 2, backend="gloo", timeout_s=5,
                              store_dir=str(tmp_path / "hang"))
