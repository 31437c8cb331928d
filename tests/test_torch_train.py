"""LoRA and full-parameter SFT of the PyTorch port (``chatts_tpu_torch/train``)
against the JAX package's ``chatts_tpu/train`` on the CPU, at the tiny size
of ``tests/test_train.py`` (hidden 32, 2 layers, 4/2 heads, vocab 256), with
the same seeded numpy inputs on both sides.  Each JAX side is one jitted
call (or three steps), not JAX's 30-step loop.

Tolerances, f32 on both sides:
- ``build_sft_batch``: the arrays equal JAX's exactly.
- ``cross_entropy``: 1e-6 relative.
- The LoRA and the full-parameter loss: 1e-5 relative; every gradient
  tensor within 1e-4 of its largest element (the same f32 products in
  another order), with ``remat`` on and off.
- Three optimizer steps from the same state: every element within 1e-2 x
  lr of optax's.  Adam divides each element by its own running magnitude,
  so a rounding in a gradient near 0 moves that element's update by a share
  of lr, not of the gradient.

The ``gpu`` tests at the end hold the card's bf16 LoRA loss and adapter
gradients to the CPU's f32 plain path, as ``chip_smoke.py`` phase 9a does
at 14B widths; they skip without a card.  This file imports JAX only
inside the CPU tests' fixture, so on a machine without JAX run the GPU
tests without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_train.py -m gpu
"""
import copy
import os
import types

import numpy as np
import pytest
import torch

from chatts_tpu_torch.core.config import tiny_config
from chatts_tpu_torch.models import chatts, qwen
from chatts_tpu_torch.models import weights as tweights
from chatts_tpu_torch.models.convert import from_jax_params
from chatts_tpu_torch.models.quantize import quantize_llm
from chatts_tpu_torch.ops import flash_attention as fa
from chatts_tpu_torch.ops import int4_matmul as i4
from chatts_tpu_torch.ops import ragged_decode_attention as rda
from chatts_tpu_torch.processor.processor import ChatTSProcessor
from chatts_tpu_torch.train import data, lora, peft_io, sft_driver, train_step
from chatts_tpu_torch.train.loss import cross_entropy

TINY = dict(vocab_size=256, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, patch_size=4,
            max_sequence_length=64, ts_token_start_index=240)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of the tensor's largest element
STEP_TOL = 1e-2  # of lr, elementwise


class Words:
    """A word tokenizer: one id in [10, 200) per word (FNV-1a)."""

    pad_token_id = 0
    eos_token_id = 1

    def encode(self, text, add_special_tokens=False):
        out = []
        for word in text.split():
            h = 2166136261
            for c in word:
                h = (h ^ ord(c)) * 16777619 & 0xFFFFFFFF
            out.append(10 + h % 190)
        return out

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"t{int(i)}" for i in ids)


def make_rows(n=8, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input": f"analyze series number {i} <ts><ts/> now",
             "output": f"the trend is increasing case {i}",
             "timeseries": [rng.normal(0, 1, 16).tolist()]} for i in range(n)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side: config, f32 params from PRNGKey(0), processor."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from chatts_tpu.core.config import tiny_config as jtiny
    from chatts_tpu.models import chatts as jchatts
    from chatts_tpu.processor.processor import ChatTSProcessor as JProcessor
    from chatts_tpu.train import data as jdata
    from chatts_tpu.train import lora as jlora
    from chatts_tpu.train import loss as jloss
    from chatts_tpu.train import peft_io as jpeft
    from chatts_tpu.train import sft_driver as jsft
    from chatts_tpu.train import train_step as jstep

    cfg = jtiny(**TINY)
    params = jchatts.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, cfg=cfg, params=params, proc=JProcessor(Words(), cfg),
        np_params=jax.tree.map(np.asarray, params), data=jdata, lora=jlora, loss=jloss,
        peft=jpeft, sft=jsft, step=jstep)


@pytest.fixture(scope="module")
def port():
    cfg = tiny_config(**TINY)
    return types.SimpleNamespace(cfg=cfg, proc=ChatTSProcessor(Words(), cfg))


def port_model(jx, port):
    return from_jax_params(jx.np_params, port.cfg, device="cpu")


def jax_batch(jx, batch):
    return {k: jx.jnp.asarray(v) for k, v in batch.items()}


def jax_lora(jx, rank=4, seed=1, b_scale=0.05, params=None):
    """JAX adapters with a nonzero b, so every adapter gets a gradient."""
    jlcfg = jx.lora.LoRAConfig(rank=rank)
    tree = jx.lora.init_lora(jx.params if params is None else params, jlcfg,
                             jx.jax.random.PRNGKey(seed))
    key = jx.jax.random.PRNGKey(seed + 1)
    for layer in tree["layers"]:
        for ab in layer.values():
            key, sub = jx.jax.random.split(key)
            ab["b"] = b_scale * jx.jax.random.normal(sub, ab["b"].shape)
    return jlcfg, tree


def jax_leaf(tree, name):
    """The JAX param tree's leaf for a port parameter name."""
    parts = name.split(".")
    if parts[0] == "ts_encoder" and parts[1] in ("kernels", "biases"):
        return tree["ts_encoder"]["mlp"][int(parts[2])][
            "kernel" if parts[1] == "kernels" else "bias"]
    node = tree
    for p in parts:
        node = node[int(p)] if p.isdigit() else node[p]
    return node


def assert_grad_close(got, ref, what):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy()
    err = np.abs(got - ref).max()
    assert err <= GRAD_TOL * max(np.abs(ref).max(), 1e-30), f"{what}: {err}"


# ---------------------------------------------------------------------------
# Data and loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 5])
def test_torch_build_sft_batch_equals_jax(jx, port, n):
    rows = make_rows(n, seed=n)
    want = jx.data.build_sft_batch(jx.proc, rows, max_answer_tokens=5)
    got = data.build_sft_batch(port.proc, rows, max_answer_tokens=5)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    processed = [p(["a <ts><ts/> b"], [np.arange(9.0)]) for p in (jx.proc, port.proc)]
    labels = (want["targets"][:1], want["loss_mask"][:1])
    built_j = jx.step.build_training_batch(processed[0], *labels)
    built_p = train_step.build_training_batch(processed[1], *labels)
    assert sorted(built_p) == sorted(built_j)
    for key in built_j:
        np.testing.assert_array_equal(built_p[key], built_j[key], err_msg=key)
    order_j = [b["input_ids"] for b in jx.data.batch_iterator(jx.proc, make_rows(8), 3, seed=4)]
    order_p = [b["input_ids"] for b in data.batch_iterator(port.proc, make_rows(8), 3, seed=4)]
    assert len(order_p) == len(order_j) == 2
    for a, b in zip(order_p, order_j):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("empty_mask", [False, True])
def test_torch_cross_entropy_matches_jax(jx, empty_mask):
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 3, (2, 5, 17)).astype(np.float32)
    targets = rng.integers(0, 17, (2, 5)).astype(np.int32)
    mask = np.zeros((2, 5), np.float32) if empty_mask else (
        rng.random((2, 5)) > 0.4).astype(np.float32)
    want_loss, want_count = jx.loss.cross_entropy(
        jx.jnp.asarray(logits), jx.jnp.asarray(targets), jx.jnp.asarray(mask))
    loss, count = cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                                torch.from_numpy(mask))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    assert float(count) == float(want_count)


# ---------------------------------------------------------------------------
# Gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

def qwen3_family(jx):
    """The Qwen3 decoder (qk_norm, no attention bias) at TINY: the JAX config
    and f32 params, with q_norm and k_norm drawn in [0.5, 1.5] so that
    neither is a no-op, and the port's config and processor."""
    from chatts_tpu.core.config import tiny_config as jtiny
    from chatts_tpu.models import chatts as jchatts

    cfg = jtiny(**TINY, qwen3=True)
    params = jchatts.init_params(cfg, jx.jax.random.PRNGKey(0), dtype=jx.jnp.float32)
    rng = np.random.default_rng(0)
    for layer in params["llm"]["layers"]:
        for norm in ("q_norm", "k_norm"):
            layer["self_attn"][norm] = jx.jnp.asarray(
                rng.uniform(0.5, 1.5, layer["self_attn"][norm].shape), jx.jnp.float32)
    pcfg = tiny_config(**TINY, qwen3=True)
    return cfg, params, types.SimpleNamespace(cfg=pcfg, proc=ChatTSProcessor(Words(), pcfg))


@pytest.mark.parametrize("remat,qwen3", [(False, False), (True, False), (True, True)],
                         ids=["False", "True", "qwen3-True"])
def test_torch_lora_loss_and_grads_match_jax(jx, port, remat, qwen3):
    jcfg, jparams = jx.cfg, jx.params
    if qwen3:
        jcfg, jparams, port = qwen3_family(jx)
    batch = data.build_sft_batch(port.proc, make_rows(4))
    jlcfg, jtree = jax_lora(jx, params=jparams)
    grad_fn = jx.jax.jit(jx.jax.value_and_grad(jx.sft.lora_loss_fn, has_aux=True),
                         static_argnums=(2, 3, 5))
    (want, _), jgrads = grad_fn(jtree, jparams, jcfg, jlcfg, jax_batch(jx, batch), remat)

    model = from_jax_params(jx.jax.tree.map(np.asarray, jparams), port.cfg, device="cpu")
    assert (model.llm.layers[0].self_attn.q_norm is not None) == qwen3
    adapters = lora.lora_from_jax(jx.jax.tree.map(np.asarray, jtree), device="cpu")
    loss, metrics = sft_driver.lora_loss_fn(adapters, model, lora.LoRAConfig(rank=4),
                                            data.to_device(batch, "cpu"), remat)
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_RTOL)
    assert float(metrics["tokens"]) == float(batch["loss_mask"].sum())
    for i, (jl, tl) in enumerate(zip(jgrads["layers"], adapters["layers"])):
        assert sorted(jl) == sorted(tl)
        for module, ab in tl.items():
            for k in ("a", "b"):
                assert_grad_close(ab[k].grad, jl[module][k], f"layer {i} {module}.{k}")
    # The base, Qwen3's q_norm and k_norm too, stays frozen; after the call
    # the adapters are detached.
    assert all(p.grad is None for p in model.parameters())
    assert all(m.lora is None for m in model.modules() if isinstance(m, qwen.Dense))


@pytest.mark.parametrize("remat", [False, True])
def test_torch_full_loss_and_grads_match_jax(jx, port, remat):
    batch = data.build_sft_batch(port.proc, make_rows(3))
    grad_fn = jx.jax.jit(jx.jax.value_and_grad(jx.step.loss_fn, has_aux=True),
                         static_argnums=(1, 3))
    (want, _), jgrads = grad_fn(jx.params, jx.cfg, jax_batch(jx, batch), remat)

    model = port_model(jx, port)
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss, _ = train_step.loss_fn(model, data.to_device(batch, "cpu"), remat)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=LOSS_RTOL)
    # Every leaf of the JAX tree is a port parameter, and the other way round.
    assert len(params) == len(jx.jax.tree.leaves(jx.params))
    for name, p in params.items():
        assert_grad_close(p.grad, jax_leaf(jgrads, name), name)


def test_torch_remat_gives_the_same_loss_and_grads(jx, port):
    batch = data.to_device(data.build_sft_batch(port.proc, make_rows(4)), "cpu")
    _, jtree = jax_lora(jx)
    grads = []
    for remat in (False, True):
        model = port_model(jx, port)
        adapters = lora.lora_from_jax(jx.jax.tree.map(np.asarray, jtree), device="cpu")
        loss, _ = sft_driver.lora_loss_fn(adapters, model, lora.LoRAConfig(rank=4), batch, remat)
        grads.append((loss, [t.grad for t in lora.lora_parameters(adapters)]))
    assert torch.equal(grads[0][0], grads[1][0])
    for g0, g1 in zip(grads[0][1], grads[1][1]):
        assert torch.equal(g0, g1)


# ---------------------------------------------------------------------------
# Optimizer steps against optax
# ---------------------------------------------------------------------------

CLIPS = {"no_clip": 1e6, "clip": 1e-4}


def _batches(jx, port, n):
    jb = list(jx.data.batch_iterator(jx.proc, make_rows(8), 2, seed=0))[:n]
    pb = list(data.batch_iterator(port.proc, make_rows(8), 2, seed=0))[:n]
    return jb, pb


@pytest.mark.parametrize("clip", list(CLIPS))
def test_torch_lora_steps_match_optax(jx, port, clip):
    lr = 1e-2
    jb, pb = _batches(jx, port, 3)
    jlcfg, jtree = jax_lora(jx, b_scale=0.0)  # init_lora's zero b, as training starts
    # remat off: the gradient tests hold it; here it would only add compile time.
    jtc = jx.step.TrainConfig(learning_rate=lr, grad_clip=CLIPS[clip], remat=False)
    jstep_fn, optimizer = jx.sft.make_lora_train_step(jx.cfg, jlcfg, jtc)
    jstate = optimizer.init(jtree)
    start = jx.jax.tree.map(np.asarray, jtree)
    for b in jb:
        jtree, jstate, _ = jstep_fn(jtree, jstate, jx.params, jax_batch(jx, b))

    model = port_model(jx, port)
    adapters = lora.lora_from_jax(start, device="cpu")
    tc = train_step.TrainConfig(learning_rate=lr, grad_clip=CLIPS[clip], remat=False)
    step, _ = sft_driver.make_lora_train_step(model, adapters, lora.LoRAConfig(rank=4), tc)
    norms = [float(step(data.to_device(b, "cpu"))["grad_norm"]) for b in pb]
    assert all((n >= CLIPS[clip]) == (clip == "clip") for n in norms), norms
    want = lora.lora_to_numpy(adapters)
    for jl, tl in zip(jx.jax.tree.map(np.asarray, jtree)["layers"], want["layers"]):
        for module in jl:
            for k in ("a", "b"):
                np.testing.assert_allclose(tl[module][k], jl[module][k], rtol=0,
                                           atol=STEP_TOL * lr, err_msg=f"{module}.{k}")
    # The base did not move.
    for name, p in port_model(jx, port).named_parameters():
        assert torch.equal(p, dict(model.named_parameters())[name]), name


@pytest.mark.parametrize("clip", list(CLIPS))
def test_torch_full_steps_match_optax(jx, port, clip):
    lr = 1e-3
    jb, pb = _batches(jx, port, 3)
    jtc = jx.step.TrainConfig(learning_rate=lr, grad_clip=CLIPS[clip], weight_decay=0.1,
                              remat=False)
    jstep_fn, optimizer = jx.step.make_train_step(jx.cfg, jtc)
    jparams, jstate = jx.params, optimizer.init(jx.params)
    for b in jb:
        jparams, jstate, _ = jstep_fn(jparams, jstate, jax_batch(jx, b))

    model = port_model(jx, port)
    tc = train_step.TrainConfig(learning_rate=lr, grad_clip=CLIPS[clip], weight_decay=0.1,
                                remat=False)
    step, _ = train_step.make_train_step(model, tc)
    norms = [float(step(data.to_device(b, "cpu"))["grad_norm"]) for b in pb]
    assert all((n >= CLIPS[clip]) == (clip == "clip") for n in norms), norms
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jax_leaf(jparams, name)),
                                   rtol=0, atol=STEP_TOL * lr, err_msg=name)


def test_torch_clip_by_global_norm_is_optax_formula():
    g = [torch.tensor([3.0, 0.0]), torch.tensor([[4.0]])]
    norm = train_step.clip_by_global_norm_(g, 1.0)
    assert float(norm) == 5.0
    assert torch.equal(g[0], torch.tensor([3.0, 0.0]) / 5.0)  # not 1 / (5 + 1e-6)
    assert torch.equal(g[1], torch.tensor([[4.0]]) / 5.0)
    kept = [torch.tensor([0.3, 0.4])]
    train_step.clip_by_global_norm_(kept, 1.0)
    assert torch.equal(kept[0], torch.tensor([0.3, 0.4]))


# ---------------------------------------------------------------------------
# Adapters: init, refusals, merge, PEFT and merged export
# ---------------------------------------------------------------------------

def test_torch_init_lora_zero_b_is_identity(jx, port):
    model = port_model(jx, port)
    cfg = lora.LoRAConfig(rank=4)
    adapters = lora.init_lora(model, cfg, torch.Generator().manual_seed(1))
    jtree = jx.lora.init_lora(jx.params, jx.lora.LoRAConfig(rank=4), jx.jax.random.PRNGKey(1))
    assert lora.lora_param_count(adapters) == jx.lora.lora_param_count(jtree) > 0
    for jl, tl in zip(jtree["layers"], adapters["layers"]):
        assert list(tl) == list(jl) == list(lora.DEFAULT_TARGETS)
        for module, ab in tl.items():
            assert ab["a"].shape == jl[module]["a"].shape and ab["a"].requires_grad
            assert ab["a"].dtype == torch.float32 and 0.01 < float(ab["a"].detach().std()) < 0.03
            assert not ab["b"].any() and ab["b"].shape == jl[module]["b"].shape
    batch = data.to_device(data.build_sft_batch(port.proc, make_rows(2)), "cpu")
    with torch.no_grad():
        plain, _ = train_step.loss_fn(model, batch, remat=False)
        with_lora, _ = sft_driver.lora_loss_fn(adapters, model, cfg, batch, remat=False)
    assert torch.equal(plain, with_lora)


def _float_and_other(jx, port, layout):
    """A float model and the same weights fused, or quantized to int4 / int8
    (hidden 128, so that q_proj tiles for the int4 kernel)."""
    if layout == "fused":
        return port_model(jx, port), chatts.maybe_fuse(port_model(jx, port))
    cfg = tiny_config(hidden_size=128, intermediate_size=256, num_attention_heads=2,
                      num_key_value_heads=1)

    def make():
        return chatts.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                                  dtype=torch.float32)

    quantized = make()
    quantize_llm(quantized.llm, bits=4 if layout == "int4" else 8)
    return make(), quantized


@pytest.mark.parametrize("layout", ["int4", "int8", "fused"])
def test_torch_lora_refuses_quantized_and_fused(jx, port, layout):
    float_model, model = _float_and_other(jx, port, layout)
    if layout == "int4":
        assert model.llm.layers[0].self_attn.q_proj.kernel_q4 is not None
    cfg = lora.LoRAConfig(rank=4)
    with pytest.raises(ValueError, match="fused|quantized"):
        lora.init_lora(model, cfg, torch.Generator().manual_seed(0))
    adapters = lora.init_lora(float_model, cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="fused|quantized"):
        with lora.applied_lora(model, adapters, cfg):
            pass
    with pytest.raises(ValueError, match="fused|quantized"):
        lora.merge_lora(model, adapters, cfg)


def test_torch_merge_lora_matches_jax_and_leaves_the_base(jx, port):
    jlcfg, jtree = jax_lora(jx)
    want = jx.lora.merge_lora(jx.params, jtree, jlcfg)
    model = port_model(jx, port)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    adapters = lora.lora_from_jax(jx.jax.tree.map(np.asarray, jtree), device="cpu")
    cfg = lora.LoRAConfig(rank=4)
    merged = lora.merge_lora(model, adapters, cfg)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for name, p in merged.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jax_leaf(want, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    q = merged.llm.layers[0].self_attn.q_proj.kernel
    assert not torch.equal(q, model.llm.layers[0].self_attn.q_proj.kernel)
    assert merged.llm.embed_tokens is model.llm.embed_tokens  # shared, not copied
    same = lora.merge_lora(model, adapters, cfg, in_place=True)
    assert same is model and torch.equal(model.llm.layers[0].self_attn.q_proj.kernel, q)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_torch_peft_adapter_round_trip_across_packages(jx, tmp_path, writer):
    jlcfg, jtree = jax_lora(jx)
    jlcfg = jx.lora.LoRAConfig(rank=4, alpha=8.0)
    path = str(tmp_path / "adapter")
    if writer == "port":
        peft_io.save_peft_adapter(path, lora.LoRAConfig(rank=4, alpha=8.0),
                                  lora.lora_from_jax(jx.jax.tree.map(np.asarray, jtree), "cpu"))
        cfg, tree = jx.peft.load_peft_adapter(path)
        tree = jx.jax.tree.map(np.asarray, tree)
    else:
        jx.peft.save_peft_adapter(path, jlcfg, jtree)
        cfg, adapters = peft_io.load_peft_adapter(path, device="cpu")
        assert all(t.requires_grad for t in lora.lora_parameters(adapters))
        tree = lora.lora_to_numpy(adapters)
    assert (cfg.rank, cfg.alpha, tuple(cfg.target_modules)) == (4, 8.0, lora.DEFAULT_TARGETS)
    for want, got in zip(jtree["layers"], tree["layers"]):
        for module in want:
            for k in ("a", "b"):
                np.testing.assert_array_equal(got[module][k], np.asarray(want[module][k]))


def test_torch_export_merged_loads_in_both_packages(jx, port, tmp_path):
    from chatts_tpu.models import weights as jweights

    _, jtree = jax_lora(jx)
    model = port_model(jx, port)
    cfg = lora.LoRAConfig(rank=4)
    adapters = lora.lora_from_jax(jx.jax.tree.map(np.asarray, jtree), device="cpu")
    out = str(tmp_path / "merged")
    sft_driver.export_merged(model, adapters, port.cfg, cfg, out)
    merged = lora.merge_lora(model, adapters, cfg)
    _, jparams = jweights.load_checkpoint(out, dtype=jx.jnp.float32)
    _, loaded = tweights.load_checkpoint(out, dtype=torch.float32, device="cpu")
    loaded_params = dict(loaded.named_parameters())
    for name, p in merged.named_parameters():
        np.testing.assert_array_equal(np.asarray(jax_leaf(jparams, name)), p.detach().numpy(),
                                      err_msg=name)
        assert torch.equal(loaded_params[name], p), name
    # The base is unchanged.
    for name, p in port_model(jx, port).named_parameters():
        assert torch.equal(p, dict(model.named_parameters())[name]), name


# ---------------------------------------------------------------------------
# The SFT driver
# ---------------------------------------------------------------------------

def test_torch_lora_sft_reduces_loss(jx, port):
    result = sft_driver.train_lora_sft(
        port_model(jx, port), port.cfg, port.proc, make_rows(8),
        lora_cfg=lora.LoRAConfig(rank=8, alpha=16.0),
        train_cfg=train_step.TrainConfig(learning_rate=3e-2),
        batch_size=4, num_epochs=30, max_steps=30, seed=0, device="cpu")
    assert result.steps == 30 and len(result.losses) == 30
    first, last = np.mean(result.losses[:3]), np.mean(result.losses[-3:])
    assert last < first * 0.9, f"loss did not drop: {first} -> {last}"


def test_torch_lora_sft_resumes_from_its_checkpoint(jx, port, tmp_path):
    ckpt = str(tmp_path / "ckpts")
    kwargs = dict(batch_size=4, num_epochs=10, checkpoint_dir=ckpt, checkpoint_every=2,
                  device="cpu")
    model = port_model(jx, port)
    r1 = sft_driver.train_lora_sft(model, port.cfg, port.proc, make_rows(8), max_steps=4,
                                   **kwargs)
    assert r1.steps == 4 and sorted(os.listdir(ckpt)) == ["2", "4"]
    # The newest state holds r1's adapters.
    fresh = lora.init_lora(model, lora.LoRAConfig(), torch.Generator().manual_seed(7))
    opt = train_step.make_optimizer(train_step.TrainConfig(), lora.lora_parameters(fresh))
    assert sft_driver.restore_train_state(ckpt, fresh, opt) == 4
    for a, b in zip(lora.lora_parameters(fresh), lora.lora_parameters(r1.lora_params)):
        assert torch.equal(a, b)
    r2 = sft_driver.train_lora_sft(model, port.cfg, port.proc, make_rows(8), max_steps=2,
                                   **kwargs)
    assert r2.steps == 6 and len(r2.losses) == 2
    assert sorted(os.listdir(ckpt)) == ["4", "6"]


def test_torch_train_entry_points_default_to_the_card():
    import inspect

    for fn in (sft_driver.train_lora_sft, chatts.init_params, qwen.init_params,
               peft_io.load_peft_adapter, lora.lora_from_jax, data.to_device):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


# ---------------------------------------------------------------------------
# The kernels refuse gradients
# ---------------------------------------------------------------------------

def _kernel_calls(dev):
    """Each kernel wrapper with small inputs on ``dev``; ``grad`` makes the
    float inputs need gradients."""
    g = torch.Generator().manual_seed(0)

    def t(*shape, dtype=torch.bfloat16, grad=False):
        return torch.randn(shape, generator=g).to(dev, dtype).requires_grad_(grad)

    def flash(grad):
        pos = torch.arange(64, dtype=torch.int32, device=dev)[None]
        return fa.flash_attention(t(1, 64, 2, 128, grad=grad), t(1, 64, 1, 128), t(1, 64, 1, 128),
                                  q_positions=pos, kv_positions=pos,
                                  kv_valid=torch.ones(1, 64, dtype=torch.bool, device=dev))

    def decode(grad):
        return rda.ragged_decode_attention(
            t(1, 2, 128, grad=grad), t(1, 1, 64, 128), t(1, 1, 64, 128),
            torch.tensor([40], dtype=torch.int32, device=dev))

    def decode_int8(grad):
        codes = torch.randint(-127, 128, (1, 1, 64, 128), generator=g).to(dev, torch.int8)
        return rda.ragged_decode_attention_int8(
            t(1, 2, 128, grad=grad), codes, codes, t(1, 1, 64, dtype=torch.float32).abs(),
            t(1, 1, 64, dtype=torch.float32).abs(), torch.tensor([40], dtype=torch.int32,
                                                                  device=dev))

    packed, scales = i4.pack_int4(torch.randn(128, 128, generator=g))
    packed, scales = packed.to(dev), scales.to(dev)

    def int4(grad):
        return i4.int4_matmul(t(4, 128, grad=grad), packed, scales)

    def int4_a8(grad):
        xq = torch.randint(-127, 128, (4, 128), generator=g).to(dev, torch.int8)
        return i4.int4_matmul_a8(xq, t(4, dtype=torch.float32, grad=grad).abs(), packed, scales)

    return {"flash_attention": flash, "ragged_decode_attention": decode,
            "ragged_decode_attention_int8": decode_int8, "int4_matmul": int4,
            "int4_matmul_a8": int4_a8}


@pytest.mark.parametrize("kernel", ["flash_attention", "ragged_decode_attention",
                                    "ragged_decode_attention_int8", "int4_matmul",
                                    "int4_matmul_a8"])
def test_torch_kernel_wrappers_refuse_gradients(kernel):
    call = _kernel_calls("cpu")[kernel]
    with pytest.raises(RuntimeError, match=f"{kernel}: the kernel has no backward"):
        call(True)
    with torch.no_grad():
        assert torch.isfinite(call(True).float()).all()
    assert torch.isfinite(call(False).float()).all()


def test_torch_training_attention_is_plain_never_the_kernel(jx, port):
    """``attn_impl="auto"`` reaches the prefill kernel's wrapper, which
    refuses a forward that autograd records; the training loss passes "xla"."""
    model = port_model(jx, port)
    batch = data.to_device(data.build_sft_batch(port.proc, make_rows(2)), "cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    with pytest.raises(RuntimeError, match="flash_attention"):
        model(batch["input_ids"], batch["positions"], ts_values=batch["ts_values"],
              ts_mask=batch["ts_mask"], scatter_seq=batch["scatter_seq"],
              scatter_tok=batch["scatter_tok"], kv_valid=batch["attention_mask"].bool(),
              kv_positions=batch["positions"])
    loss, _ = train_step.loss_fn(model, batch, remat=False)
    loss.backward()
    assert model.llm.layers[0].self_attn.q_proj.kernel.grad.abs().sum() > 0


def test_torch_init_params_matches_jax_layout(jx):
    jtiny_params = jx.np_params
    model = chatts.init_params(tiny_config(**TINY), torch.Generator().manual_seed(0),
                               device="cpu", dtype=torch.float32)
    params = dict(model.named_parameters())
    assert len(params) == len(jx.jax.tree.leaves(jtiny_params))
    for name, p in params.items():
        want = np.asarray(jax_leaf(jtiny_params, name))
        assert tuple(p.shape) == want.shape and p.dtype == torch.float32, name
        if name.endswith(("layernorm", ".norm", "bias", "biases.0", "biases.1")):
            assert torch.equal(p, torch.from_numpy(np.array(want))), name  # ones and zeros
    kernel = params["llm.layers.0.mlp.down_proj.kernel"]
    assert abs(float(kernel.std()) * 64 ** 0.5 - 1) < 0.1  # normal / sqrt(fan_in)
    assert abs(float(params["llm.embed_tokens"].std()) / 0.02 - 1) < 0.1


# ---------------------------------------------------------------------------
# On the card (phase 9a's checks at a small size)
# ---------------------------------------------------------------------------

# The card's bf16 path against the CPU's f32 plain path on the same weights:
# the loss within 1% and each adapter gradient within 5% relative L2 error.
# bf16 rounds activations, the merged kernels and the cotangents entering the
# backward products to 8 bits of mantissa (2**-9 relative each); through two
# layers and a 1,024-word head that gave errors well inside these bounds on
# an H100 (chip_smoke.py prints the measured ones at 14B widths).
CARD_LOSS_RTOL = 1e-2
CARD_GRAD_RL2 = 5e-2
SMALL = dict(vocab_size=1024, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=64, patch_size=8,
             max_sequence_length=256, ts_token_start_index=1000)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _card_setup(cuda):
    cfg = tiny_config(**SMALL)
    model = chatts.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda,
                               dtype=torch.bfloat16)
    rows = [{"input": f"look at <ts><ts/> and say {i} " + "word " * 40,
             "output": "rising then flat " * 6, "timeseries": [np.sin(np.arange(96) / 7) + i]}
            for i in range(2)]
    batch = data.build_sft_batch(ChatTSProcessor(Words(), cfg), rows)
    return cfg, model, batch


def rel_l2(got, ref):
    return float((got.float().cpu() - ref).norm() / ref.norm().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [False, True])
def test_torch_lora_grads_on_the_card_match_the_cpu(cuda, remat):
    _, model, batch = _card_setup(cuda)
    lcfg = lora.LoRAConfig(rank=8)
    adapters = lora.init_lora(model, lcfg, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for t in lora.lora_parameters(adapters)[1::2]:  # every b nonzero
            t.normal_(0, 0.02)
    loss, _ = sft_driver.lora_loss_fn(adapters, model, lcfg, data.to_device(batch, cuda), remat)
    cpu_model = copy.deepcopy(model).to("cpu").float()
    cpu_adapters = {"layers": [{m: {k: t.detach().cpu().requires_grad_() for k, t in ab.items()}
                                for m, ab in layer.items()} for layer in adapters["layers"]]}
    ref, _ = sft_driver.lora_loss_fn(cpu_adapters, cpu_model, lcfg,
                                     data.to_device(batch, "cpu"), remat)
    assert abs(float(loss) - float(ref)) <= CARD_LOSS_RTOL * abs(float(ref))
    for got, want in zip(lora.lora_parameters(adapters), lora.lora_parameters(cpu_adapters)):
        assert torch.isfinite(got.grad).all()
        assert rel_l2(got.grad, want.grad) <= CARD_GRAD_RL2


@pytest.mark.gpu
def test_torch_full_step_on_the_card_moves_every_tensor(cuda):
    _, model, batch = _card_setup(cuda)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for fn in (fa.flash_attention, rda.ragged_decode_attention,
               rda.ragged_decode_attention_int8, i4.int4_matmul, i4.int4_matmul_a8):
        fn.launches = 0
    # lr 1e-2: Adam moves each element by about lr, and a bf16 norm weight of
    # 1.0 moves only by more than half its ulp (2**-9).
    step, _ = train_step.make_train_step(model, train_step.TrainConfig(learning_rate=1e-2))
    metrics = step(data.to_device(batch, cuda))
    assert torch.isfinite(metrics["loss"])
    for n, p in model.named_parameters():
        assert not torch.equal(p, before[n]), n
    assert fa.flash_attention.launches == 0 and i4.int4_matmul.launches == 0


@pytest.mark.gpu
def test_torch_export_merged_on_the_card_loads_bit_equal(cuda, tmp_path):
    cfg, model, _ = _card_setup(cuda)
    lcfg = lora.LoRAConfig(rank=8)
    adapters = lora.init_lora(model, lcfg, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for t in lora.lora_parameters(adapters)[1::2]:
            t.normal_(0, 0.02)
    sft_driver.export_merged(model, adapters, cfg, lcfg, str(tmp_path))
    merged = lora.merge_lora(model, adapters, lcfg)
    _, loaded = tweights.load_checkpoint(str(tmp_path), dtype=torch.bfloat16, device=cuda)
    got = dict(loaded.named_parameters())
    for name, p in merged.named_parameters():
        assert torch.equal(got[name], p), name


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["flash_attention", "ragged_decode_attention",
                                    "ragged_decode_attention_int8", "int4_matmul",
                                    "int4_matmul_a8"])
def test_torch_kernel_wrappers_refuse_gradients_on_the_card(cuda, kernel):
    call = _kernel_calls(cuda)[kernel]
    with pytest.raises(RuntimeError, match=f"{kernel}: the kernel has no backward"):
        call(True)
    with torch.no_grad():
        assert torch.isfinite(call(True).float()).all()


@pytest.mark.gpu
def test_torch_matmul_f32_backward_on_the_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(37, 256, generator=g, device=cuda).bfloat16().requires_grad_()
    w = torch.randn(256, 96, generator=g, device=cuda).bfloat16().requires_grad_()
    out = qwen.matmul_f32(x, w)
    assert out.dtype == torch.float32
    cot = torch.randn(out.shape, generator=g, device=cuda)
    out.backward(cot)
    c = cot.bfloat16().float()
    dx = (c @ w.detach().float().t()).bfloat16()
    dw = (x.detach().float().t() @ c).bfloat16()
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.bfloat16
    assert torch.allclose(x.grad.float(), dx.float(), rtol=2 ** -7, atol=1e-3)
    assert torch.allclose(w.grad.float(), dw.float(), rtol=2 ** -7, atol=1e-3)
