"""Training on a (dp, tp) mesh in the port (``chatts_tpu_torch/train/``,
``parallel/mesh.py``'s autograd collectives) against single-device
training and the JAX package, on a real ``gloo`` world of 4 CPU processes,
at the config of ``tests/test_train.py`` (hidden 32, 2 layers, 4 heads over
2 kv heads, vocab 256, f32).

One world (``run_world``, a ``file://`` store under the test's temporary
directory) runs every case once; this process computes the single-device
and JAX sides while it runs.  The ranks import nothing of JAX.  The meshes:
tp = 2 (two of them side by side, one a half of the world), tp = 4 (the 2
kv heads do not split over 4, so the attention is replicated whole, by
``parallel/sharding.py``'s rule, and only the MLP and the vocabulary
shard) and dp = 2 x tp = 2.

- The repair: at tp = 2 and at dp = 2 x tp = 2 the LoRA loss records a
  graph and every adapter of all seven projections (column and row
  layers) gets a gradient equal to single-device's (rtol 1e-5, atol 1e-5 of the tensor's largest: the
  shards' products sum in another order; 8e-7 of the largest seen).
  Before, the in-place sums and the gathered logits cut the graph and
  nothing trained.
- ``train_lora_sft`` at tp = 4 and at dp = 2 x tp = 2, with
  ``tests/test_train.py:209-221``'s arguments, from the adapters JAX's
  ``train_lora_sft`` draws (saved as the run's checkpoint of step 0, which
  it resumes): the losses follow JAX's single-device ones (rtol 2e-3, atol
  2e-4).  On dp x tp the run saved and resumed from its checkpoints gives
  the single-device resumed run's losses.
- One full-parameter step at tp = 2 and at dp = 2 x tp = 2 with the clip
  triggered: every gradient (clipped) and the global norm equal
  single-device's, sliced
  (1e-5 of the tensor's largest; rtol 1e-5), every tensor after AdamW
  within 1e-2 x lr plus lr x min(2, d / (|g| + eps)), d 1e-5 of the
  tensor's largest gradient (Adam's update is set by rounding where a
  gradient lies within its rounding of 0; ``tests/test_torch_pipeline.py``).
- The vocab-parallel loss at tp = 4 and its logits' gradient equal
  ``cross_entropy``'s (rtol 1e-6; 1e-6 of the largest).
- The PEFT files and the merged export written from dp = 2 x tp = 2 are
  byte-equal to single-device's; ``save_checkpoint`` refuses a shard.
- ``init_params(mesh=)``, which cuts each layer as it is drawn, gives the
  tensors of ``place_params`` of the whole draw, to the bit.

The world's join is bounded (60 s)."""
import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

from chatts_tpu_torch.core import config as tconfig
from chatts_tpu_torch.models import chatts as tchatts
from chatts_tpu_torch.models import weights as tweights
from chatts_tpu_torch.models.convert import from_jax_params
from chatts_tpu_torch.parallel import distributed, sharding
from chatts_tpu_torch.parallel import mesh as tmesh
from chatts_tpu_torch.processor.processor import ChatTSProcessor
from chatts_tpu_torch.train import data, lora, peft_io, sft_driver, train_step
from chatts_tpu_torch.train.loss import cross_entropy, masked_mean, vocab_parallel_nll
from tests.helpers import FakeTokenizer

WORLD_TIMEOUT_S = 60
# tests/test_train.py:27-30
TINY = dict(vocab_size=256, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, patch_size=4,
            max_sequence_length=64, ts_token_start_index=240)
ALL_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
# tests/test_train.py:209-213
SFT_KWARGS = dict(batch_size=4, num_epochs=4, max_steps=8, seed=0)
SFT_RANK, SFT_ALPHA, SFT_LR = 4, 8.0, 1e-2
FULL_LR, FULL_CLIP = 1e-3, 1e-4
FULL_ROWS = {"tp2": 3, "dp2_tp2": 4}
STEP_TOL = 1e-2


def make_rows(n=8):
    """``tests/test_train.py::make_rows``."""
    rng = np.random.default_rng(0)
    return [{"input": f"analyze series number {i} <ts><ts/> now",
             "output": f"the trend is increasing case {i}",
             "timeseries": [rng.normal(0, 1, 16).tolist()]} for i in range(n)]


def _cfg():
    return tconfig.tiny_config(**TINY)


def _proc(cfg):
    return ChatTSProcessor(FakeTokenizer(vocab_limit=200), cfg)


def _adapters(tree):
    return lora.lora_from_jax(tree, device="cpu")


SFT_TC = train_step.TrainConfig(learning_rate=SFT_LR)


def _start_from(tree, checkpoint_dir):
    """Save the adapters ``tree`` as ``checkpoint_dir``'s step 0, with a
    fresh optimizer, for ``train_lora_sft`` to resume (every rank of a
    world calls it; rank 0 writes)."""
    start = _adapters(tree)
    sft_driver.save_train_state(checkpoint_dir, 0, start, train_step.make_optimizer(
        SFT_TC, lora.lora_parameters(start)))


def _sft_kwargs(checkpoint_dir, **kw):
    return dict(SFT_KWARGS, lora_cfg=lora.LoRAConfig(rank=SFT_RANK, alpha=SFT_ALPHA),
                train_cfg=SFT_TC, device="cpu", log_every=10 ** 9,
                checkpoint_dir=checkpoint_dir, **kw)


def _grads(adapters):
    return [t.grad.numpy().copy() for t in lora.lora_parameters(adapters)]


def _cut_dims(model):
    """{parameter name: the dim tp cuts it along, or None}."""
    dims = {}
    for mname, module in model.named_modules():
        from chatts_tpu_torch.models.qwen import Dense, QwenModel

        if isinstance(module, Dense) and module.tp_kind:
            for field in ("kernel", "bias"):
                if getattr(module, field) is not None:
                    dims[f"{mname}.{field}"] = sharding.shard_dim(module.tp_kind, field)
        if isinstance(module, QwenModel) and module.vocab_start is not None:
            dims[f"{mname}.embed_tokens"] = 0
            dims[f"{mname}.lm_head"] = 1
    return dims


# ---------------------------------------------------------------------------
# The ranks (no JAX here)
# ---------------------------------------------------------------------------

def _repair(model, cfg, tree_lora):
    adapters = _adapters(tree_lora)
    batch = data.to_device(data.build_sft_batch(_proc(cfg), make_rows(4)), "cpu")
    lcfg = lora.LoRAConfig(rank=SFT_RANK, target_modules=ALL_TARGETS)
    with lora.applied_lora(model, adapters, lcfg):
        recorded = train_step.loss_fn(model, batch, True)[0].requires_grad
    loss, _ = sft_driver.lora_loss_fn(adapters, model, lcfg, batch, remat=True)
    return dict(loss=float(loss), recorded=recorded, grads=_grads(adapters))


def _full_step(model, cfg, rows):
    batch = data.to_device(data.build_sft_batch(_proc(cfg), make_rows(rows)), "cpu")
    tc = train_step.TrainConfig(learning_rate=FULL_LR, weight_decay=0.1, grad_clip=FULL_CLIP,
                                remat=False)
    step, _ = train_step.make_train_step(model, tc)
    metrics = step(batch)
    dims = _cut_dims(model)
    return dict(loss=float(metrics["loss"]), norm=float(metrics["grad_norm"]),
                tensors={n: (p.detach().numpy().copy(), p.grad.numpy().copy(), dims.get(n))
                         for n, p in model.named_parameters()})


def _vocab_loss(mesh, inputs):
    logits, targets, mask = (torch.from_numpy(inputs[k]) for k in ("logits", "targets", "mask"))
    start, stop = sharding.shard_range(logits.shape[-1], mesh)
    local = logits[..., start:stop].clone().requires_grad_()
    loss, count = masked_mean(vocab_parallel_nll(local, targets, mesh, start), mask, mesh)
    loss.backward()
    return dict(loss=float(loss.detach()), count=float(count), grad=local.grad.numpy(), start=start)


def _files(path):
    out = {}
    for root, _, names in os.walk(path):
        for name in names:
            with open(os.path.join(root, name), "rb") as f:
                out[os.path.relpath(os.path.join(root, name), path)] = f.read()
    return out


def _rank_main(rank, tree, loras, vocab_inputs, root):
    torch.set_num_threads(1)
    cfg = _cfg()
    proc = _proc(cfg)
    whole = from_jax_params(tree, cfg, "cpu")
    mesh22 = tmesh.create_mesh(dp=2, tp=2)
    mesh14 = tmesh.create_mesh(dp=1, tp=4)
    # Each half of the world is a tp = 2 mesh of its own.
    half = dataclasses.replace(mesh22, shape={"dp": 1, "tp": 2}, dp_index=0, dp_ranks=(rank,),
                               dp_group=None)
    out = {"repair": {}, "full": {}}
    for name, mesh in (("tp2", half), ("dp2_tp2", mesh22)):
        out["repair"][name] = _repair(sharding.place_params(mesh, cfg, whole, device="cpu"),
                                      cfg, loras["nonzero_all"])
        out["full"][name] = _full_step(sharding.place_params(mesh, cfg, whole, device="cpu"),
                                       cfg, FULL_ROWS[name])
    out["vocab"] = _vocab_loss(mesh14, vocab_inputs)
    rows = make_rows(8)
    out["sft"] = {}
    for name, mesh in (("tp4", mesh14), ("dp2_tp2", mesh22)):
        model = sharding.place_params(mesh, cfg, whole, device="cpu")
        ckpt = os.path.join(root, f"sft_{name}")
        _start_from(loras["sft"], ckpt)
        out["sft"][name] = sft_driver.train_lora_sft(model, cfg, proc, rows,
                                                     **_sft_kwargs(ckpt)).losses
    # Resume on dp x tp: 4 steps saved every 2, then 4 more from the newest.
    model = sharding.place_params(mesh22, cfg, whole, device="cpu")
    ckpt = os.path.join(root, "ckpt")
    _start_from(loras["sft"], ckpt)
    kwargs = _sft_kwargs(ckpt, max_steps=4, checkpoint_every=2)
    r1 = sft_driver.train_lora_sft(model, cfg, proc, rows, **kwargs)
    saved = sorted(os.listdir(ckpt))
    r2 = sft_driver.train_lora_sft(model, cfg, proc, rows, **kwargs)
    out["resume"] = dict(first=r1.losses, saved=saved, second=r2.losses, steps=r2.steps,
                         adapters=lora.lora_to_numpy(r2.lora_params))
    # PEFT files and the merged export from dp x tp.
    lcfg = lora.LoRAConfig(rank=SFT_RANK, alpha=SFT_ALPHA, target_modules=ALL_TARGETS)
    adapters = _adapters(loras["nonzero_all"])
    peft_io.save_peft_adapter(os.path.join(root, "peft"), lcfg, adapters)
    sft_driver.export_merged(model, adapters, cfg, lcfg, os.path.join(root, "merged"))
    out["files"] = (_files(os.path.join(root, "peft")), _files(os.path.join(root, "merged")))
    try:
        tweights.save_checkpoint(os.path.join(root, f"refused{rank}"), cfg, model)
    except ValueError as err:
        out["refused"] = str(err)
    for name, mesh in (("tp4", mesh14), ("dp2_tp2", mesh22)):
        drawn = tchatts.init_params(cfg, torch.Generator().manual_seed(5), "cpu", mesh=mesh)
        placed = sharding.place_params(mesh, cfg, tchatts.init_params(
            cfg, torch.Generator().manual_seed(5), "cpu"), device="cpu")
        a, b = dict(drawn.named_parameters()), dict(placed.named_parameters())
        out.setdefault("init", {})[name] = (sorted(a) == sorted(b) and len(a) > 20, [
            n for n in a if not torch.equal(a[n], b[n])])
    return out


# ---------------------------------------------------------------------------
# This process: the JAX package's and the single device's sides
# ---------------------------------------------------------------------------

def _jax_side():
    import jax
    import jax.numpy as jnp

    from chatts_tpu.core.config import tiny_config
    from chatts_tpu.models import chatts
    from chatts_tpu.train import lora as jlora

    cfg = tiny_config(**TINY)
    params = chatts.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    # train_lora_sft's own draw for seed 0 (chatts_tpu/train/sft_driver.py:100).
    sft = jlora.init_lora(params, jlora.LoRAConfig(rank=SFT_RANK, alpha=SFT_ALPHA),
                          jax.random.PRNGKey(0))
    nonzero = jlora.init_lora(params, jlora.LoRAConfig(rank=SFT_RANK, target_modules=ALL_TARGETS),
                              jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(2)
    for layer in nonzero["layers"]:
        for ab in layer.values():
            key, sub = jax.random.split(key)
            ab["b"] = 0.05 * jax.random.normal(sub, ab["b"].shape)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return cfg, params, to_np(params), {"sft": to_np(sft), "nonzero_all": to_np(nonzero)}


def _jax_sft_losses(cfg, params):
    from chatts_tpu.processor.processor import ChatTSProcessor as JProcessor
    from chatts_tpu.train.lora import LoRAConfig
    from chatts_tpu.train.sft_driver import train_lora_sft
    from chatts_tpu.train.train_step import TrainConfig

    return train_lora_sft(params, cfg, JProcessor(FakeTokenizer(vocab_limit=200), cfg),
                          make_rows(8), lora_cfg=LoRAConfig(rank=SFT_RANK, alpha=SFT_ALPHA),
                          train_cfg=TrainConfig(learning_rate=SFT_LR), **SFT_KWARGS).losses


def _vocab_inputs():
    rng = np.random.default_rng(3)
    return dict(logits=rng.normal(0, 3, (2, 5, 256)).astype(np.float32),
                targets=rng.integers(0, 256, (2, 5)).astype(np.int64),
                mask=(rng.random((2, 5)) > 0.3).astype(np.float32))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jcfg, params, tree, loras = _jax_side()
    vocab_inputs = _vocab_inputs()
    root = str(tmp_path_factory.mktemp("tp_train"))
    box = []

    def run():
        try:
            box.append(distributed.run_world(
                _rank_main, 4, (tree, loras, vocab_inputs, root), backend="gloo",
                timeout_s=WORLD_TIMEOUT_S, store_dir=os.path.join(root, "store")))
        except BaseException as err:  # re-raised below
            box.append(err)

    thread = threading.Thread(target=run)
    thread.start()
    jax_losses = _jax_sft_losses(jcfg, params)
    thread.join()
    if isinstance(box[0], BaseException):
        raise box[0]
    return dict(results=box[0], tree=tree, loras=loras, jax_losses=jax_losses,
                vocab=vocab_inputs, root=root)


def _single(world):
    cfg = _cfg()
    return cfg, from_jax_params(world["tree"], cfg, "cpu")


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["tp2", "dp2_tp2"])
def test_torch_tp_lora_gradients_match_single_device(world, case):
    cfg, model = _single(world)
    want = _repair(model, cfg, world["loras"]["nonzero_all"])
    assert want["recorded"]
    names = [f"{i}.{m}.{k}" for i in range(2) for m in ALL_TARGETS for k in ("a", "b")]
    for rank, res in enumerate(world["results"]):
        got = res["repair"][case]
        assert got["recorded"], rank  # the loss records a graph on the shard
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert len(got["grads"]) == len(want["grads"]) == len(names)
        for name, g, w in zip(names, got["grads"], want["grads"]):
            assert g.shape == w.shape, (name, g.shape)  # whole adapters, not shard-shaped
            assert np.abs(g).max() > 0, (rank, name)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{rank} {name}")


@pytest.mark.parametrize("case", ["tp4", "dp2_tp2"])
def test_torch_tp_train_lora_sft_matches_jax_single_device(world, case):
    want = world["jax_losses"]
    assert len(want) == 8
    for rank, res in enumerate(world["results"]):
        np.testing.assert_allclose(res["sft"][case], want, rtol=2e-3, atol=2e-4,
                                   err_msg=f"rank {rank}")


def test_torch_tp_train_lora_sft_resumes_on_a_mesh(world, tmp_path):
    cfg, model = _single(world)
    proc, rows = _proc(cfg), make_rows(8)
    ckpt = str(tmp_path / "ckpt")
    _start_from(world["loras"]["sft"], ckpt)
    kwargs = _sft_kwargs(ckpt, max_steps=4, checkpoint_every=2)
    first = sft_driver.train_lora_sft(model, cfg, proc, rows, **kwargs).losses
    second = sft_driver.train_lora_sft(model, cfg, proc, rows, **kwargs)
    for res in world["results"]:
        got = res["resume"]
        assert got["saved"] == ["2", "4"] and got["steps"] == 8 == second.steps
        np.testing.assert_allclose(got["first"], first, rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(got["second"], second.losses, rtol=2e-3, atol=2e-4)
        for gl, wl in zip(got["adapters"]["layers"], lora.lora_to_numpy(
                second.lora_params)["layers"]):
            for module in wl:
                for k in ("a", "b"):
                    np.testing.assert_allclose(gl[module][k], wl[module][k], rtol=0,
                                               atol=STEP_TOL * SFT_LR)
    # Every rank resumed the same state.
    first_rank = world["results"][0]["resume"]["adapters"]
    for res in world["results"][1:]:
        for gl, wl in zip(res["resume"]["adapters"]["layers"], first_rank["layers"]):
            for module in wl:
                for k in ("a", "b"):
                    np.testing.assert_array_equal(gl[module][k], wl[module][k])


@pytest.mark.parametrize("case", ["tp2", "dp2_tp2"])
def test_torch_tp_full_parameter_step_matches_single_device(world, case):
    cfg, model = _single(world)
    want = _full_step(model, cfg, FULL_ROWS[case])
    for rank, res in enumerate(world["results"]):
        got = res["full"][case]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["norm"], want["norm"], rtol=1e-5)
        assert got["norm"] > FULL_CLIP  # the clip ran, with the whole model's norm
        assert sorted(got["tensors"]) == sorted(want["tensors"])
        sharded = 0
        for name, (p, g, dim) in got["tensors"].items():
            wp, wg, _ = want["tensors"][name]
            if dim is not None:
                sharded += 1
                start, stop = sharding.split_range(wp.shape[dim], rank % 2, 2)
                wp, wg = (np.take(x, np.arange(start, stop), axis=dim) for x in (wp, wg))
            assert p.shape == wp.shape, name
            np.testing.assert_allclose(g, wg, rtol=0, atol=1e-5 * np.abs(wg).max(),
                                       err_msg=name)
            gmax = np.abs(want["tensors"][name][1]).max()
            tol = STEP_TOL * FULL_LR + FULL_LR * np.minimum(2.0, 1e-5 * gmax / (np.abs(wg) + 1e-8))
            assert (np.abs(p - wp) <= tol).all(), (name, float(np.abs(p - wp).max()))
        # q/k/v/o, gate/up/down and the q/k/v biases of 2 layers, the
        # vocabulary and the head.
        assert sharded == 2 * (7 + 3) + 2


def test_torch_tp4_vocab_parallel_loss_matches_cross_entropy(world):
    x = world["vocab"]
    logits = torch.from_numpy(x["logits"]).requires_grad_()
    want, count = cross_entropy(logits, torch.from_numpy(x["targets"]),
                                torch.from_numpy(x["mask"]))
    want.backward()
    got = np.zeros_like(x["logits"])
    for res in world["results"]:
        v = res["vocab"]
        np.testing.assert_allclose(v["loss"], float(want.detach()), rtol=1e-6)
        assert v["count"] == float(count)
        got[..., v["start"]:v["start"] + v["grad"].shape[-1]] = v["grad"]
    ref = logits.grad.numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_torch_tp_peft_files_and_merged_export_byte_equal_to_single_device(world, tmp_path):
    cfg, model = _single(world)
    lcfg = lora.LoRAConfig(rank=SFT_RANK, alpha=SFT_ALPHA, target_modules=ALL_TARGETS)
    adapters = _adapters(world["loras"]["nonzero_all"])
    peft_io.save_peft_adapter(str(tmp_path / "peft"), lcfg, adapters)
    sft_driver.export_merged(model, adapters, cfg, lcfg, str(tmp_path / "merged"))
    want = (_files(str(tmp_path / "peft")), _files(str(tmp_path / "merged")))
    assert sorted(want[0]) == ["adapter_config.json", "adapter_model.safetensors"]
    assert "model.safetensors" in want[1]
    for rank, res in enumerate(world["results"]):
        assert res["files"][0] == want[0], rank
        assert sorted(res["files"][1]) == sorted(want[1])
        for name in want[1]:
            assert res["files"][1][name] == want[1][name], (rank, name)


@pytest.mark.parametrize("case", ["tp4", "dp2_tp2"])
def test_torch_tp_init_params_on_a_mesh_equals_place_params(world, case):
    for res in world["results"]:
        same_names, differ = res["init"][case]
        assert same_names and differ == []


def test_torch_tp_save_checkpoint_refuses_a_shard(world):
    for res in world["results"]:
        assert "not a tp shard" in res["refused"]
    assert not any(name.startswith("refused") for name in os.listdir(world["root"]))
