"""GPipe in the port (``chatts_tpu_torch/parallel/pipeline.py``) against the
JAX package, on a real ``gloo`` world of 4 CPU processes; the cases of
``tests/test_pipeline.py``, at its config (4 layers, hidden 64, f32).

One world (``run_world``, a ``file://`` store under the test's temporary
directory) runs every case once; this process computes JAX's side while
it runs.  The ranks import nothing of JAX.

- pp = 4: ``pipeline_forward``'s hidden state on every stage equals JAX's
  ``qwen.forward`` (rtol 2e-4, atol 2e-5), and ``make_pp_train_step``'s
  first loss JAX's plain loss (rtol 1e-4).
- pp = 2, two pipelines side by side: one takes 5 steps at lr 1e-2 and its
  loss falls; the other takes 3 at lr 1e-3, and every stage's tensors then
  equal JAX's plain forward trained by three ``optax.adamw(1e-3)`` steps
  (``tests/test_pipeline.py:85-113`` holds JAX's pipeline loss to that
  plain loss; JAX's own pipeline tests are slow-marked): within 1e-2 x lr,
  plus, for each step, lr x min(2, d / (|g| + eps)), d 1e-5 of the
  tensor's largest gradient g in that step.  Adam moves an element by
  about lr x g / (|g| + eps), so where a gradient lies within its
  rounding of 0 (the microbatches sum it in another order) the update is
  set by the rounding: one element of 8,192 had g = -5e-9 against a
  largest 0.035, and moved 0.15 lr apart.
- Tied embeddings (the head is the embedding's table, which every stage
  keeps): pp = 2 (two pipelines side by side) and pp = 4 (one, so two
  middle stages hold a copy they do not use) take 3 steps at lr 1e-3;
  every stage's tensors then equal JAX's plain forward of the tied model
  trained by ``optax.adamw(1e-3)``, at the tolerance above, and the
  table's copies are equal on every stage of a pipeline.
- The refusals JAX makes: layers that pp does not divide, a batch that the
  microbatches do not divide; a tensor-parallel shard does not stack.
- ``init_stage``, which draws every layer and keeps the stage's, equals
  ``place_stacked`` of the whole draw, to the bit.

The world's join is bounded (60 s)."""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from chatts_tpu_torch.core import config as tconfig
from chatts_tpu_torch.models.convert import from_jax_params
from chatts_tpu_torch.parallel import distributed, pipeline
from chatts_tpu_torch.parallel import mesh as tmesh

WORLD_TIMEOUT_S = 60
# tests/test_pipeline.py:15-19
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
            num_attention_heads=4, num_key_value_heads=2, patch_size=4,
            max_sequence_length=64, ts_token_start_index=240)
LEARN_LR, LEARN_STEPS = 1e-2, 5
MATCH_LR, MATCH_STEPS = 1e-3, 3
STEP_TOL = 1e-2  # of lr, elementwise (tests/test_torch_train.py)


def batchify(seed=0, b=4, t=16):
    """``tests/test_pipeline.py::_batchify`` in numpy."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 200, size=(b, t)).astype(np.int32)
    return {"input_ids": ids, "positions": np.tile(np.arange(t, dtype=np.int32), (b, 1)),
            "attention_mask": np.ones((b, t), np.int32), "targets": np.roll(ids, -1, axis=1),
            "loss_mask": np.ones((b, t), np.float32)}


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _tied(cfg):
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, tie_word_embeddings=True))


def _untied(tree):
    """The llm of ``tree`` without its separate head: a tied decoder."""
    return dict(tree, llm={k: v for k, v in tree["llm"].items() if k != "lm_head"})


def _match_steps(cfg, stacked, mesh):
    """MATCH_STEPS pipeline steps at MATCH_LR on ``batchify(1)``: the
    stage's tensors after them."""
    step, optimizer = pipeline.make_pp_train_step(
        cfg.llm, mesh, pipeline.PipelineTrainConfig(learning_rate=MATCH_LR, microbatches=2))
    state = optimizer.init(stacked)
    for _ in range(MATCH_STEPS):
        stacked, state, _ = step(stacked, state, _tensors(batchify(1)))
    return _stage_tensors(stacked)


def _stage_tensors(stacked):
    """{JAX llm path: numpy} of a stage's tensors."""
    out = {}
    for name, p in stacked.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            parts[1] = str(stacked.layer_start + int(parts[1]))
        out[".".join(parts)] = p.detach().numpy().copy()
    return out


# ---------------------------------------------------------------------------
# The ranks (no JAX here)
# ---------------------------------------------------------------------------

def _rank_main(rank, tree):
    torch.set_num_threads(1)
    cfg = tconfig.tiny_config(**TINY)
    whole = from_jax_params(tree, cfg, "cpu")
    stacked = pipeline.stack_layers(whole.llm)
    out = {}
    # pp = 4: the forward and the first loss.
    pp4 = pipeline.create_pp_mesh(4)
    mine = pipeline.place_stacked(pp4, stacked, "cpu")
    b = _tensors(batchify(0))
    m, mb, t = 2, 2, b["input_ids"].shape[1]
    embeds = whole.llm.embed(b["input_ids"]).reshape(m, mb, t, -1) if pp4.is_first else None
    hidden = pipeline.pipeline_forward(mine, cfg.llm, embeds, b["positions"].reshape(m, mb, t),
                                       b["attention_mask"].bool().reshape(m, mb, t), mesh=pp4)
    out["forward"] = hidden.reshape(4, t, -1).numpy()
    out["layers"] = (mine.layer_start, len(mine.layers), mine.embed_tokens is not None,
                     mine.lm_head is not None)
    step, optimizer = pipeline.make_pp_train_step(
        cfg.llm, pp4, pipeline.PipelineTrainConfig(microbatches=2))
    _, _, metrics = step(mine, optimizer.init(mine), _tensors(batchify(2)))
    out["loss"] = float(metrics["loss"])
    # The refusals, before any message.
    out["refusals"] = {}
    try:
        step(mine, optimizer.init(mine), {k: v[:3] for k, v in _tensors(batchify(2)).items()})
    except ValueError as err:
        out["refusals"]["microbatches"] = str(err)
    try:
        pipeline.pipeline_forward(mine, tconfig.tiny_config(**dict(TINY, num_hidden_layers=6)).llm,
                                  embeds, b["positions"].reshape(m, mb, t),
                                  b["attention_mask"].bool().reshape(m, mb, t), mesh=pp4)
    except ValueError as err:
        out["refusals"]["layers"] = str(err)
    # pp = 2: ranks 0-1 learn, ranks 2-3 match optax's steps.
    pp2 = pipeline.create_pp_mesh(2)
    learn = rank < 2
    lr, steps = (LEARN_LR, LEARN_STEPS) if learn else (MATCH_LR, MATCH_STEPS)
    mine = pipeline.place_stacked(pp2, stacked, "cpu")
    step, optimizer = pipeline.make_pp_train_step(
        cfg.llm, pp2, pipeline.PipelineTrainConfig(learning_rate=lr, microbatches=2))
    state = optimizer.init(mine)
    batch = _tensors(batchify(1))
    losses, sent = [], []
    for _ in range(steps):
        mine, state, metrics = step(mine, state, batch)
        losses.append(float(metrics["loss"]))
        sent.append(metrics["sent_bytes"])
    out["pp2"] = dict(learn=learn, losses=losses, sent=sent, tensors=_stage_tensors(mine),
                      stage=pp2.stage)
    # Tied embeddings at pp = 2 and pp = 4.
    tcfg = _tied(cfg)
    tied = pipeline.stack_layers(from_jax_params(_untied(tree), tcfg, "cpu").llm)
    assert tied.tied and tied.lm_head is None
    out["tied"] = {}
    for pp, mesh in ((2, pp2), (4, pp4)):
        out["tied"][pp] = dict(stage=mesh.stage, tensors=_match_steps(
            tcfg, pipeline.place_stacked(mesh, tied, "cpu"), mesh))
    # init_stage against place_stacked of the whole draw.
    from chatts_tpu_torch.models import qwen as tqwen

    drawn = pipeline.init_stage(cfg.llm, torch.Generator().manual_seed(5), pp4, "cpu")
    placed = pipeline.place_stacked(pp4, pipeline.stack_layers(tqwen.init_params(
        cfg.llm, torch.Generator().manual_seed(5), "cpu")), "cpu")
    a, b = dict(drawn.named_parameters()), dict(placed.named_parameters())
    out["init_stage"] = (sorted(a) == sorted(b), [n for n in a if not torch.equal(a[n], b[n])])
    # A tensor-parallel shard does not stack.
    from chatts_tpu_torch.parallel import sharding

    shard = sharding.place_params(tmesh.create_mesh(tp=4), cfg, whole, device="cpu")
    try:
        pipeline.stack_layers(shard.llm)
    except ValueError as err:
        out["refusals"]["tp_shard"] = str(err)
    return out


# ---------------------------------------------------------------------------
# JAX's side
# ---------------------------------------------------------------------------

def _jax_setup():
    import jax
    import jax.numpy as jnp

    from chatts_tpu.core.config import tiny_config
    from chatts_tpu.models import chatts

    cfg = tiny_config(**TINY)
    return cfg, chatts.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)


def _jax_loss_fn(cfg):
    import jax.numpy as jnp

    from chatts_tpu.models import qwen
    from chatts_tpu.train.loss import cross_entropy

    def loss_fn(llm, batch):
        embeds = qwen.embed_tokens(llm, batch["input_ids"])
        hidden, _ = qwen.forward(llm, cfg.llm, embeds, batch["positions"],
                                 kv_valid=batch["attention_mask"].astype(bool),
                                 kv_positions=batch["positions"], attn_impl="xla")
        logits = qwen.compute_logits(llm, cfg.llm, hidden)
        return cross_entropy(logits, batch["targets"], batch["loss_mask"])[0]

    return loss_fn, jnp


def _jax_reference(cfg, params):
    import jax
    import optax

    from chatts_tpu.models import qwen

    loss_fn, jnp = _jax_loss_fn(cfg)
    llm = params["llm"]
    b = {k: jnp.asarray(v) for k, v in batchify(0).items()}
    embeds = qwen.embed_tokens(llm, b["input_ids"])
    forward, _ = qwen.forward(llm, cfg.llm, embeds, b["positions"],
                              kv_valid=b["attention_mask"].astype(bool),
                              kv_positions=b["positions"], attn_impl="xla")
    loss = loss_fn(llm, {k: jnp.asarray(v) for k, v in batchify(2).items()})
    tied_cfg = _tied(cfg)
    tied_loss_fn, _ = _jax_loss_fn(tied_cfg)
    return dict(forward=np.asarray(forward), loss=float(loss),
                trained=_optax_steps(loss_fn, llm),
                tied=_optax_steps(tied_loss_fn, _untied(params)["llm"]))


def _optax_steps(loss_fn, llm):
    """``llm`` after MATCH_STEPS ``optax.adamw(MATCH_LR)`` steps on
    ``batchify(1)``, and each step's gradients."""
    import jax
    import jax.numpy as jnp
    import optax

    optimizer = optax.adamw(MATCH_LR)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    state = optimizer.init(llm)
    batch = {k: jnp.asarray(v) for k, v in batchify(1).items()}
    grads_by_step = []
    for _ in range(MATCH_STEPS):
        _, grads = grad_fn(llm, batch)
        grads_by_step.append(jax.tree.map(np.asarray, grads))
        updates, state = optimizer.update(grads, state, llm)
        llm = optax.apply_updates(llm, updates)
    return dict(params=jax.tree.map(np.asarray, llm), grads=grads_by_step)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax

    cfg, params = _jax_setup()
    tree = jax.tree.map(np.asarray, params)
    box = []

    def run():
        try:
            box.append(distributed.run_world(
                _rank_main, 4, (tree,), backend="gloo", timeout_s=WORLD_TIMEOUT_S,
                store_dir=str(tmp_path_factory.mktemp("pp_world"))))
        except BaseException as err:  # re-raised below
            box.append(err)

    thread = threading.Thread(target=run)
    thread.start()
    want = _jax_reference(cfg, params)
    thread.join()
    if isinstance(box[0], BaseException):
        raise box[0]
    return dict(results=box[0], want=want)


def _leaf(tree, path):
    node = tree
    for p in path.split("."):
        node = node[int(p)] if p.isdigit() else node[p]
    return node


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

def test_torch_pp_forward_matches_single_device(world):
    for rank, res in enumerate(world["results"]):
        np.testing.assert_allclose(res["forward"], world["want"]["forward"], rtol=2e-4,
                                   atol=2e-5, err_msg=f"rank {rank}")


def test_torch_pp_stages_hold_their_layers_and_the_vocabulary_where_used(world):
    layouts = [res["layers"] for res in world["results"]]
    assert layouts == [(0, 1, True, False), (1, 1, False, False), (2, 1, False, False),
                       (3, 1, False, True)]


def test_torch_pp_loss_matches_nonpp(world):
    for res in world["results"]:
        np.testing.assert_allclose(res["loss"], world["want"]["loss"], rtol=1e-4)


def test_torch_pp_train_step_learns(world):
    runs = [res["pp2"] for res in world["results"] if res["pp2"]["learn"]]
    assert len(runs) == 2 and runs[0]["losses"] == runs[1]["losses"]
    losses = runs[0]["losses"]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses  # memorizes the tiny batch
    # A stage sends M = 2 microbatches a step, activations forward or
    # gradients back, each (2, 16, 64) f32.
    assert all(s == 2 * (2 * 16 * 64 * 4) for r in runs for s in r["sent"])


def _assert_optax_steps(tensors, want, seen):
    for path, got in tensors.items():
        seen.add(path)
        tol = STEP_TOL * MATCH_LR
        for grads in want["grads"]:
            g = np.abs(np.asarray(_leaf(grads, path)))
            tol = tol + MATCH_LR * np.minimum(2.0, 1e-5 * g.max() / (g + 1e-8))
        err = np.abs(got - np.asarray(_leaf(want["params"], path)))
        assert (err <= tol).all(), (path, float(err.max()), float((err / tol).max()))


def test_torch_pp_steps_match_plain_forward_with_optax_adamw(world):
    import jax

    want = world["want"]["trained"]
    seen = set()
    for res in world["results"]:
        if not res["pp2"]["learn"]:
            _assert_optax_steps(res["pp2"]["tensors"], want, seen)
    # The two stages together hold every tensor of the decoder.
    assert len(seen) == len(jax.tree.leaves(want["params"]))


@pytest.mark.parametrize("pp", [2, 4])
def test_torch_pp_tied_embeddings_match_optax_adamw(world, pp):
    import jax

    want = world["want"]["tied"]
    assert "lm_head" not in want["params"]
    seen = set()
    tables = {}
    for rank, res in enumerate(world["results"]):
        run = res["tied"][pp]
        assert "embed_tokens" in run["tensors"] and "lm_head" not in run["tensors"], rank
        _assert_optax_steps(run["tensors"], want, seen)
        tables.setdefault(rank // pp, []).append(run["tensors"]["embed_tokens"])
    assert len(seen) == len(jax.tree.leaves(want["params"]))
    # Every stage's copy of the table, used or not, stayed the same.
    assert len(tables) == 4 // pp
    for copies in tables.values():
        assert len(copies) == pp
        for table in copies[1:]:
            np.testing.assert_array_equal(table, copies[0])


def test_torch_pp_refusals(world):
    for res in world["results"]:
        refusals = res["refusals"]
        assert "not divisible by microbatches" in refusals["microbatches"]
        assert "6 layers not divisible by pp=4" in refusals["layers"]
        assert "not a tp shard" in refusals["tp_shard"]


def test_torch_pp_init_stage_equals_place_stacked(world):
    for res in world["results"]:
        assert res["init_stage"] == (True, [])


def test_torch_pp_create_pp_mesh_needs_the_ranks():
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        pipeline.create_pp_mesh(2)
