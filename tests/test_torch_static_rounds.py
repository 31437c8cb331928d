"""The rounds the card runs from CUDA graphs, run eagerly on the CPU against
the JAX package: the scan-sliced mixed round with fixed shapes (the
decode rows as a mask, the pad admission rows by row 0, the offsets device
scalars) against JAX ``qwen.forward_mixed`` and ``_mixed_step_all_slots``,
and the batch engine's bf16 path against JAX's ``InferenceEngine``.

Tolerances: 1e-4 (rtol and atol) in f32 with the f32 cache, as
``test_torch_mixed_admission.py``; with the int8 cache a code written from
f32 activations may round the other way at a .5 boundary (at most one step,
in few elements), and values read from the cache compare at 2e-3, as
``test_torch_int8_kv.py``.  Greedy tokens must be exact.  What a step must
not write is held to the bit: every element outside the written positions
keeps its value.  The device-scalar offsets are held to the Python ones of
the same eager step to the bit.  bf16: 2**-6 of the largest logit, as
``test_torch_int8_kv.py::test_torch_bf16_blocks_match_jax_but_for_silu``'s
hidden states (XLA's bf16 ``silu`` is one ulp off in 40% of elements)."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chatts_tpu.core import config as jconfig
from chatts_tpu.models import chatts as jchatts
from chatts_tpu.models import qwen as jqwen
from chatts_tpu.processor import processor as jprocessor
from chatts_tpu.runtime.engine import InferenceEngine as JaxEngine
from chatts_tpu.serve import scheduler as jscheduler
from chatts_tpu_torch.core import config as tconfig
from chatts_tpu_torch.core.config import GenerationConfig
from chatts_tpu_torch.models.convert import qwen_from_jax
from chatts_tpu_torch.processor import processor as tprocessor
from chatts_tpu_torch.runtime.engine import InferenceEngine
from chatts_tpu_torch.serve import scheduler
from tests.helpers import FakeTokenizer

TOL = 1e-4
DECODE_TOL = 2e-3
BF16_LOGIT_TOL_OF_MAX = 2.0 ** -6
# B decode slots (slot 2 is the admission's: inactive, its stale length
# inside the span an earlier round wrote), A admission rows (row 1 a pad,
# reading slot 0, a live one), npt prompt tokens a row a step.
B, A, NPT, CAP = 4, 2, 8, 64
ACTIVE = np.asarray([True, True, False, True])
CUR = np.asarray([20, 30, 5, 11], np.int32)
ADM_SLOTS = np.asarray([2, 0], np.int64)
ADM_SEQ_LENS = np.asarray([29, 0], np.int32)


def _config(m=tconfig):
    return m.tiny_config(vocab_size=512, hidden_size=128, intermediate_size=256,
                         num_attention_heads=4, num_key_value_heads=2, head_dim=32)


@pytest.fixture(scope="module")
def llm():
    """JAX's fused f32 decoder params and the port's model of them."""
    params = jax.tree.map(np.asarray, jqwen.fuse_projections(
        jqwen.init_params(_config(jconfig).llm, jax.random.PRNGKey(4), dtype=jnp.float32)))
    return params, qwen_from_jax(params, _config().llm)


def _random_caches(lcfg, int8: bool, rng):
    """The same random layer caches as numpy arrays: what earlier rounds
    wrote."""
    kvh, d = lcfg.num_key_value_heads, lcfg.head_dim
    out = []
    for _ in range(lcfg.num_hidden_layers):
        if int8:
            out.append(tuple(rng.integers(-127, 128, (B, kvh, CAP, d)).astype(np.int8)
                             for _ in range(2))
                       + tuple((rng.random((B, kvh, CAP)) + 0.5).astype(np.float32) / 40
                               for _ in range(2)))
        else:
            out.append(tuple(rng.normal(0, 1, (B, kvh, CAP, d)).astype(np.float32)
                             for _ in range(2)))
    return out


def _assert_caches_close(tcaches, jcaches, int8: bool) -> None:
    tol = DECODE_TOL if int8 else TOL
    for tlayer, jlayer in zip(tcaches, jcaches):
        for got, want in zip(tlayer, jlayer):
            if got.dtype == torch.bfloat16:
                # Written from f32 K/V that agree to f32 rounding: equal but
                # where one rounds to the other side of a bf16 half step.
                got, want = got.float().numpy(), np.asarray(want, np.float32)
                diff = np.abs(got - want)
                assert (diff <= 2.0 ** -7 * np.abs(want)).all() and (diff > 0).mean() < 1e-3
                continue
            got, want = got.numpy(), np.asarray(want)
            if int8 and got.dtype == np.int8:
                diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
            else:
                np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _written(b_rows, cur, adm_slot: int, span: slice) -> np.ndarray:
    """(B, CAP) bool: the positions a step may write, the active rows'
    decode positions and the real admission row's span."""
    mask = np.zeros((B, CAP), bool)
    mask[b_rows, cur[b_rows]] = True
    mask[adm_slot, span] = True
    return mask


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_torch_mixed_step_writes_nothing_for_inactive_and_pad_rows(llm, cache):
    """One mixed step with the rows as a mask and the offset and real-row
    count as device scalars: the hidden states of the active decode rows
    and of the admission rows, and every cache buffer, as JAX's (which
    drops those writes out of bounds); and every element outside the active
    rows' decode positions and the real row's span [8, 16) keeps its bits:
    the admission slot's span [0, 8), which its stale length 5 points into,
    and the span [8, 16) of slot 0, which the pad row reads."""
    params, model = llm
    jlcfg, lcfg = _config(jconfig).llm, _config().llm
    int8 = cache == "int8"
    rng = np.random.default_rng(6)
    caches = _random_caches(lcfg, int8, rng)
    jcaches = [tuple(jnp.asarray(x) for x in layer) for layer in caches]
    tcaches = [tuple(torch.from_numpy(x.copy()) for x in layer) for layer in caches]
    off, kv_limit = 8, 16
    embeds = rng.normal(0, 1, (1, B + A * NPT, lcfg.hidden_size)).astype(np.float32)
    positions = np.concatenate([CUR, np.tile(off + np.arange(NPT), A)]).astype(np.int32)[None]
    lengths = np.where(ACTIVE, CUR + 1, 1).astype(np.int32)
    kv_pos = np.tile(np.arange(CAP, dtype=np.int32)[None], (B, 1))
    write_rows = np.concatenate([np.where(ACTIVE, np.arange(B), B + A + np.arange(B)),
                                 np.repeat(np.asarray([2, B + 1]), NPT)]).astype(np.int32)
    jh, jcaches = jqwen.forward_mixed(
        params, jlcfg, jnp.asarray(embeds), jnp.asarray(positions), b=B, a=A, npt=NPT,
        write_rows=jnp.asarray(write_rows), adm_slots=jnp.asarray(ADM_SLOTS.astype(np.int32)),
        adm_seq_lens=jnp.asarray(ADM_SEQ_LENS), kv_caches=jcaches,
        dec_kv_valid=jnp.asarray((kv_pos <= CUR[:, None]) & ACTIVE[:, None]),
        kv_positions=jnp.asarray(kv_pos), dec_kv_lengths=jnp.asarray(lengths),
        kv_limit=kv_limit, attn_impl="xla")
    th = model.forward_mixed(
        torch.from_numpy(embeds), torch.from_numpy(positions), b=B, a=A, npt=NPT,
        kv_caches=tcaches, dec_rows=torch.from_numpy(ACTIVE),
        dec_kv_lengths=torch.from_numpy(lengths), adm_slots=torch.from_numpy(ADM_SLOTS),
        n_real=torch.tensor(1), adm_seq_lens=torch.from_numpy(ADM_SEQ_LENS),
        span_start=torch.tensor(off, dtype=torch.int32), kv_limit=kv_limit)
    keep = np.concatenate([np.flatnonzero(ACTIVE), B + np.arange(A * NPT)])
    tol = DECODE_TOL if int8 else TOL
    np.testing.assert_allclose(th.numpy()[0, keep], np.asarray(jh)[0, keep], rtol=tol, atol=tol)
    _assert_caches_close(tcaches, jcaches, int8)
    written = _written(np.flatnonzero(ACTIVE), CUR, 2, slice(off, off + NPT))
    assert not written[2, :off].any() and not written[0, off:off + NPT].any()
    for tlayer, layer in zip(tcaches, caches):
        for got, before in zip(tlayer, layer):
            kept = ~written[:, None, :, None] if before.ndim == 4 else ~written[:, None, :]
            kept = np.broadcast_to(kept, before.shape)
            assert np.array_equal(got.numpy()[kept], before[kept])


def _round_inputs(lcfg, int8: bool, seed: int):
    """A mixed round's inputs: the slots' caches and decode state, and an
    admission whose second round (offset 16, 2 steps of npt 8) consumes the
    real row's last prompt position 28."""
    rng = np.random.default_rng(seed)
    embeds = np.zeros((A, 32, lcfg.hidden_size), np.float32)
    embeds[0] = rng.normal(0, 1, (32, lcfg.hidden_size))
    return dict(
        caches=_random_caches(lcfg, int8, rng), embeds=embeds,
        tokens=rng.integers(10, 400, B).astype(np.int32), budget=np.asarray([9, 1, 0, 9], np.int32),
        last_hidden=(rng.normal(0, 1, (A, lcfg.hidden_size)) * [[1], [0]]).astype(np.float32))


def _port_round(model, lcfg, inp, chunk, kv_limit, o, cache_dtype=None):
    """``scheduler._mixed_round`` on the inputs: the device-scalar offsets
    of ``_MixedInputs``; float caches in ``cache_dtype``.  Returns (packed,
    tokens, cur_lens, budget, caches, last_hidden)."""
    caches = [tuple(torch.from_numpy(x.copy()).to(cache_dtype) for x in layer)
              for layer in inp["caches"]]
    tokens, cur = torch.from_numpy(inp["tokens"].copy()), torch.from_numpy(CUR.copy())
    budget, active = torch.from_numpy(inp["budget"].copy()), torch.from_numpy(ACTIVE)
    static = scheduler._MixedInputs(B, A, NPT, chunk, lcfg.hidden_size, torch.float32, "cpu")
    static.load(torch.from_numpy(inp["embeds"]), o, torch.from_numpy(ADM_SLOTS), 1,
                torch.from_numpy(ADM_SEQ_LENS), torch.from_numpy(inp["last_hidden"]), active,
                budget)
    packed = scheduler._mixed_round(
        types.SimpleNamespace(llm=model), chunk, NPT, kv_limit, caches, tokens, cur, active,
        torch.zeros(B), torch.ones(B), torch.tensor([3], dtype=torch.int32), budget,
        torch.Generator().manual_seed(0), static)
    return packed, tokens, cur, budget, caches, static.last_hidden


@pytest.mark.parametrize("cache", ["f32", "int8", "bf16"])
def test_torch_static_mixed_round_matches_jax(llm, cache):
    """A whole mixed round of 2 steps (greedy; slot 1's budget ends after one
    token, slot 2 inactive, admission row 1 a pad) against JAX's
    ``_mixed_step_all_slots``: the packed tokens and live flags, the decode
    state, every cache buffer and the captured hidden state.  bf16: the
    cache (the serving default on the card) under f32 weights, the hidden
    state at 1e-4 as in f32."""
    params, model = llm
    cfg, lcfg = _config(jconfig), _config().llm
    int8, bf16 = cache == "int8", cache == "bf16"
    inp = _round_inputs(lcfg, int8, seed=7)
    jcache = jnp.bfloat16 if bf16 else None
    chunk, kv_limit, o = 2, 32, 16
    (jcaches, jtokens, jcur, jbudget, jlast, _, jpacked) = jscheduler._mixed_step_all_slots(
        {"llm": params}, cfg, "xla", chunk, NPT, kv_limit,
        [tuple(jnp.asarray(x, jcache) for x in layer) for layer in inp["caches"]],
        jnp.asarray(inp["tokens"]), jnp.asarray(CUR), jnp.asarray(ACTIVE), jnp.zeros(B),
        jnp.ones(B), jnp.asarray([3], jnp.int32), jnp.asarray(inp["budget"]),
        jnp.asarray(ADM_SLOTS.astype(np.int32)), jnp.asarray([2, B + 1], jnp.int32),
        jnp.asarray(inp["embeds"][:, o:o + chunk * NPT]), jnp.asarray(o, jnp.int32),
        jnp.asarray(ADM_SEQ_LENS), jnp.asarray(inp["last_hidden"]), jax.random.PRNGKey(0))
    packed, tokens, cur, budget, caches, last = _port_round(
        model, lcfg, inp, chunk, kv_limit, o, torch.bfloat16 if bf16 else None)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    assert (packed.numpy()[:, :chunk] >= 0).sum() == 5  # slots 0 and 3 twice, slot 1 once
    for got, want in ((tokens, jtokens), (cur, jcur), (budget, jbudget)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_caches_close(caches, jcaches, int8)
    tol = DECODE_TOL if int8 else TOL
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=tol, atol=tol)
    assert not np.allclose(last.numpy()[0], inp["last_hidden"][0])


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_torch_device_scalar_offsets_match_python_offsets(llm, cache):
    """The round's steps with the offsets as device scalars that each step
    advances (``_MixedInputs``), against the same steps written with Python
    offsets, the active rows' indices and the real-row count (the form the
    round took before its graph): the same tokens, caches and captured
    hidden state, to the bit."""
    _, model = llm
    lcfg = _config().llm
    inp = _round_inputs(lcfg, cache == "int8", seed=8)
    chunk, kv_limit, o = 2, 32, 16
    packed, tokens, cur, budget, caches, last = _port_round(model, lcfg, inp, chunk,
                                                            kv_limit, o)

    want_caches = [tuple(torch.from_numpy(x.copy()) for x in layer) for layer in inp["caches"]]
    t, c = torch.from_numpy(inp["tokens"].copy()), torch.from_numpy(CUR.copy())
    bud, active = torch.from_numpy(inp["budget"].copy()), torch.from_numpy(ACTIVE)
    live, want_last = active & (bud > 0), torch.from_numpy(inp["last_hidden"].copy())
    seq_lens, emitted = torch.from_numpy(ADM_SEQ_LENS), []
    adm = torch.from_numpy(inp["embeds"][:, o:o + chunk * NPT])
    for i in range(chunk):
        off = o + i * NPT
        pro_pos = torch.arange(off, off + NPT, dtype=torch.int32)
        x = torch.cat([model.embed(t), adm[:, i * NPT:(i + 1) * NPT].reshape(A * NPT, -1)])[None]
        hidden = model.forward_mixed(
            x, torch.cat([c, pro_pos.repeat(A)])[None], b=B, a=A, npt=NPT,
            kv_caches=want_caches, dec_rows=torch.from_numpy(np.flatnonzero(ACTIVE)),
            dec_kv_lengths=torch.where(active, c + 1, 1), adm_slots=torch.from_numpy(ADM_SLOTS),
            n_real=1, adm_seq_lens=seq_lens, span_start=off, kv_limit=kv_limit)
        emit, t, c, bud, live = scheduler._advance(
            model.compute_logits(hidden[0, :B, None])[:, 0], t, c, live, bud, torch.zeros(B),
            torch.ones(B), torch.tensor([3], dtype=torch.int32), torch.Generator())
        emitted.append(emit)
        captured = pro_pos[None, :] == (seq_lens - 1)[:, None]
        want_last += torch.where(captured[..., None],
                                 hidden[0, B:].reshape(A, NPT, -1).float(), 0.0).sum(dim=1)
    assert torch.equal(packed, torch.cat([torch.stack(emitted, 1), live[:, None].int()], 1))
    for got, want in ((tokens, t), (cur, c), (budget, bud), (last, want_last)):
        assert torch.equal(got, want)
    for tlayer, wlayer in zip(caches, want_caches):
        for got, want in zip(tlayer, wlayer):
            assert torch.equal(got, want)


def test_torch_bf16_generate_matches_jax(monkeypatch):
    """``generate`` with bf16 weights and a bf16 cache (the batch path the
    card runs) against JAX's ``InferenceEngine`` on the same tiny model:
    the first tokens' logits within 2**-6 of the largest, and the greedy
    tokens equal.  JAX's decode takes its Pallas bf16 decode kernel in
    interpret mode (``attn_impl="ragged"``; its prefill takes the plain
    attention, as under "xla"): XLA:CPU's jitted dense decode refuses a bf16
    x bf16 -> f32 dot."""
    monkeypatch.setenv("CHATTS_RAGGED_INTERPRET", "1")
    kw = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_attention_heads=4,
              num_key_value_heads=2, head_dim=32, patch_size=4)
    jcfg, tcfg = jconfig.tiny_config(**kw), tconfig.tiny_config(**kw)
    params = jchatts.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    prompts = ["analyze <ts><ts/> please", "and <ts><ts/> this <ts><ts/> too long prompt"]
    series = [np.arange(16.0), np.sin(np.arange(32)) * 10, np.arange(8.0)]
    jbatch = jprocessor.ChatTSProcessor(FakeTokenizer(), jcfg)(prompts, series)
    tbatch = tprocessor.ChatTSProcessor(FakeTokenizer(), tcfg)(prompts, series)
    jax_engine = JaxEngine(params, jcfg, cache_dtype=jnp.bfloat16, attn_impl="ragged",
                           decode_recent_kv=False, decode_chunk=4)
    port = InferenceEngine(jax.tree.map(np.asarray, params), tcfg, device="cpu",
                           cache_dtype=torch.bfloat16, decode_chunk=4)
    assert port.model.llm.embed_tokens.dtype == torch.bfloat16

    positions = jnp.asarray(jbatch.positions)
    seq_lens = np.asarray(jbatch.seq_lens)
    jh, _ = jchatts.forward(
        params, jcfg, jnp.asarray(jbatch.input_ids), positions,
        ts_values=jnp.asarray(jbatch.ts_values), ts_mask=jnp.asarray(jbatch.ts_mask),
        scatter_seq=jnp.asarray(jbatch.scatter_seq), scatter_tok=jnp.asarray(jbatch.scatter_tok),
        kv_valid=positions < jnp.asarray(seq_lens)[:, None], kv_positions=positions,
        attn_impl="xla")
    last = jh[jnp.arange(len(seq_lens)), jnp.asarray(seq_lens) - 1][:, None]
    want_logits = np.asarray(jchatts.compute_logits(params, jcfg, last)[:, 0], np.float32)
    calls, inner = [], port.model.compute_logits

    def record(hidden):
        out = inner(hidden)
        calls.append(out[:, -1].float().numpy())
        return out

    port.model.compute_logits = record
    want = jax_engine.generate(jbatch, jconfig.GenerationConfig(max_new_tokens=12, greedy=True))
    got = port.generate(tbatch, GenerationConfig(max_new_tokens=12, greedy=True))
    err = np.abs(calls[0] - want_logits).max()
    assert err <= BF16_LOGIT_TOL_OF_MAX * np.abs(want_logits).max(), err
    assert got.token_ids == want.token_ids
