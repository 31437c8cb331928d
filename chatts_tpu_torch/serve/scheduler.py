"""Continuous-batching serving engine.

Counterpart of ``chatts_tpu/serve/scheduler.py``: a slot-based host scheduler
over one persistent KV cache of ``max_batch_size`` rows, bf16, f32 or int8
(``runtime/kv_cache.py``).  A background thread runs the engine loop, and
every piece of device state lives on the engine's device and is driven from
that thread, on its current stream.

Round forms, as in the reference:
- **monolithic admission** (no slot live): the admitted prompts prefill as
  one (A, T) block, each row's prompt K/V is copied into its slot, and the
  first tokens are sampled;
- **pure decode round**: every live slot advances ``decode_chunk`` steps on
  the device, with EOS and the token budget checked there; the host syncs
  once per round, on a packed (B, chunk + 1) result.  On the card every
  round replays a CUDA graph of one step, captured in the first;
- **block admission** (slots live, ``a * T <= block_token_budget``): the
  whole admission prefills as one block, its rows merge into the decode
  state, then either the round ends there and the first tokens stream at
  once (``block_early_emit``), or the decode chunk runs in the same round
  with the new rows live (fused; on the card the chunk replays the decode
  step's graph);
- **scan-sliced mixed admission** (slots live and the block too large, or a
  prompt above ``prefill_chunk``): every round advances the decode slots
  ``decode_chunk`` steps and, in each step, consumes ``npt`` prompt tokens
  of every admission row in the same packed stream through the projections
  (``QwenModel.forward_mixed``); the prompt K/V lands in the slots directly.
  On the card a round replays a CUDA graph of one mixed step, one graph per
  (a, npt, kv_limit), captured in the first round with that key.  After
  the round that consumes the last tokens, the first tokens are sampled
  from the hidden states captured at each row's last prompt position, and
  the rows go live.  A mixed admission whose padded prompt would not fit
  the cache takes the monolithic path instead.

Every graph (``runtime/graphs.py``) is one step over tensors that never
move, replayed once a step; its capture runs the step once eagerly first.
A capture that fails raises, and the round fails as any other does: no
round falls back to eager steps.  ``stats()`` counts the rounds run from a
graph and run eagerly, by kind, and lists each capture's key, seconds and
pool bytes.  The mixed graphs share one memory pool: they never run at
once.

What differs from the reference, and why:
- Placement is an indexed copy of the admitted rows into their slots.  The
  reference's host gather plus select and its span scatters exist because
  XLA serialises general scatters on the TPU.  A mixed step keeps the
  reference's fixed shapes, but where it routes the writes of inactive
  decode rows and pad admission rows out of bounds (dropped), an index past
  the cache would fault on the card: an inactive row writes back what its
  position holds, and a pad row writes row 0's span into row 0's slot
  again, so neither changes anything.
- Block admissions have no pad rows: eager PyTorch compiles nothing, so the
  port computes exactly the rows of the processed batch.  ``_block_family``
  stays for the eligibility rule, so both engines take the same path.  A
  scan-sliced admission keeps the reference's row family ``a``, since its
  npt cap and padded length depend on it; its pad rows have length 0 and
  change nothing.
- The reference compiles each round once per shape; the port captures one
  step of it per shape in a CUDA graph on the card and runs the same step
  functions eagerly off it.  Every round and the mixed finalize update the
  decode state in place, so every graph's replays see it.  A mixed round's
  offsets are device scalars that each step advances, and its prompt slice
  is copied into a buffer of its graph's before the round, since the
  slice's address moves.
- Decode is the per-step cache write form; the recent-KV mode is TPU-only
  machinery (ROADMAP "Not to port").
- The prompt side of a mixed step always takes the prefill attention (B1 on
  the card), as every prefill of the port does; the reference reads its
  choice from ``CHATTS_MIXED_PROMPT_ATTN``.
- ``admission_pad_to_class`` (it pads each wave to its length class to bound
  XLA compiles, and would only add pad tokens here) is not an option here,
  nor ``mixed_admission``, which no caller turns off; the reference's
  ``mixed_npt`` default is the module constant ``MIXED_NPT``.
- Shape keys that mark a round's first XLA compile (``fresh``) have no
  counterpart; ``stats()["graph_captures"]`` lists the shapes captured.

Tensor and data parallelism (a model from ``parallel/sharding.py``): JAX
runs every device from the one engine loop; here every rank builds a
``ServeEngine`` on its shard, and the driver, world rank 0 (tp rank 0 of dp
group 0), owns the queue, the loop thread and every decision, since
admission depends on arrival times and on the loop's timing.  Before each piece of device work (a monolithic
admission, the staging of a block or scan-sliced one, a round, the first
tokens of a scan-sliced admission, the rows going live) it broadcasts the
plan, the op's name and its host arguments (the processed batch, slots,
sampling parameters, budgets, the live slots); the other ranks run
``follow()``, which runs each plan's op on their shard until the driver
stops.  Sampled ids are world rank 0's, broadcast.  At dp > 1 the plans
and the ids reach the whole world, so every dp replica runs the driver's
schedule on the same requests, as JAX's engine, which never places its
cache or batch over dp (``kv_cache_specs`` and ``batch_specs`` have no
caller there), repeats the work on every replica; splitting requests over
dp would be a feature JAX's engine lacks.  The rounds' CUDA graphs are
captured only under NCCL (unverified); gloo collectives cannot be
captured, so under gloo every round runs eagerly, by the constructor's
choice, which ``stats()`` reports with its reason.

The span record: every round, and every monolithic admission, logs one
entry in ``round_log`` (``_log_round``), with the host seconds of each loop
phase it ran under the fields of ``utils/profiling.py::SPANS``: the round's
``dispatch_s``, ``wait_s`` and ``apply_s`` nest within its ``round_s``, and
the admission staged after it (``grace_s``, ``select_s``, ``process_s``,
``embed_s``, ``stage_s``) within its ``admit_s``; each field is a phase's
self time, so the fields add up.  What the loop does while no round is in
flight (``idle_s``, and an admission made then) adds up into the next
round's entry, within its ``gap_s``; a monolithic admission's own entry
holds the phases of its prefill (dispatch, the first tokens' fetch, apply),
and the admission that made it holds the rest.  On the card world rank
0 also stamps each entry from CUDA events read on the same host clock:
``dev_start`` and ``dev_end``, when the device began and ended the round,
``pre_dev_s``, the device seconds of the work launched since the previous
round (staging, the first tokens of a scan-sliced admission), and
``embed_dev_s``, those of the embeddings (``_embed``) launched since then.
Every field is final when the entry is logged: an event is read only after
the fetch that follows it, so an embedding launched after round n's fetch
is reported in round n + 1's entry.  Off the card and on follower ranks the
device fields are None.  While ``torch.profiler`` records on the loop's
thread, every span is also a range under its name.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import sys
import threading
import time
import traceback
import uuid
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from chatts_tpu_torch.core import encoding
from chatts_tpu_torch.core.config import ChatTSConfig
from chatts_tpu_torch.processor.processor import ChatTSProcessor
from chatts_tpu_torch.utils.profiling import (SPANS, DeviceClock, MetricsAggregator,
                                              SpanTimer, device_gap_s)
from chatts_tpu_torch.models.chatts import ChatTSModel, maybe_fuse
from chatts_tpu_torch.models.convert import from_jax_params
from chatts_tpu_torch.ops import fused_glue
from chatts_tpu_torch.parallel.mesh import broadcast_from_driver
from chatts_tpu_torch.parallel.sharding import infer_mesh
from chatts_tpu_torch.runtime import graphs, kv_cache, sampling

# The most prompt tokens an admission row consumes in one step of a
# scan-sliced mixed round (the reference engine's ``mixed_npt`` default).
MIXED_NPT = 64
# Under tensor parallelism an idle driver sends an empty plan this often, so
# the followers' wait for the next plan never reaches the group's timeout
# (``init_process_group``'s: 30 minutes by default for gloo, 10 for NCCL).
HEARTBEAT_S = 10.0


@dataclasses.dataclass
class SamplingParams:
    max_tokens: int = 512
    temperature: float = 0.2
    top_p: float = 1.0
    stop_token_ids: Sequence[int] = ()


@dataclasses.dataclass
class Request:
    prompt: str
    timeseries: List[np.ndarray]
    params: SamplingParams
    request_id: str = dataclasses.field(default_factory=lambda: uuid.uuid4().hex)
    # Filled by the engine:
    created_s: float = dataclasses.field(default_factory=time.perf_counter)
    first_token_s: Optional[float] = None
    finished_s: Optional[float] = None
    prompt_tokens: int = 0
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    stream_queue: "queue.Queue[Optional[List[int]]]" = dataclasses.field(
        default_factory=queue.Queue
    )
    finish_reason: Optional[str] = None
    error: Optional[str] = None
    cancelled: bool = False
    # Length class for admission grouping (engine-filled, cached): the pow2
    # >= 256 ceiling of the exact prompt token count, or -1 when the prompt
    # fails to encode (such a request admits alone, so the per-request error
    # isolation catches it without failing a wave).
    token_class: Optional[int] = None
    # When submit() queued it and when an admission took it off the queue
    # (time.perf_counter), and that admission's route: "mono", "block" or
    # "mixed".
    submitted_s: Optional[float] = None
    admitted_s: Optional[float] = None
    route: Optional[str] = None

    def cancel(self) -> None:
        """Request cancellation (client disconnect); honoured at the next
        scheduler round."""
        self.cancelled = True

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.created_s


class _WaitQueue:
    """FIFO wait queue that the admission path can also inspect in place:
    the ``queue.Queue`` surface the engine uses (put / get_nowait / empty /
    qsize) plus snapshot / remove / requeue, so length-classed admission can
    take a same-class wave from the middle of the backlog without losing
    arrival order for everyone else."""

    def __init__(self):
        self._d: "list[Request]" = []
        self._lock = threading.Lock()

    def put(self, item) -> None:
        with self._lock:
            self._d.append(item)

    def get_nowait(self):
        with self._lock:
            if not self._d:
                raise queue.Empty
            return self._d.pop(0)

    def empty(self) -> bool:
        with self._lock:
            return not self._d

    def qsize(self) -> int:
        with self._lock:
            return len(self._d)

    def snapshot(self) -> list:
        with self._lock:
            return list(self._d)

    def remove(self, items) -> None:
        with self._lock:
            ids = {id(r) for r in items}
            self._d = [r for r in self._d if id(r) not in ids]

    def requeue(self, items) -> None:
        """Put items back at the FRONT, in order (they were the oldest of
        their class; appending would let newer arrivals jump them)."""
        with self._lock:
            self._d = list(items) + self._d


# ---------------------------------------------------------------------------
# Device functions.  Each runs on the engine's device with no host sync; the
# caches and the (B,) decode state are updated in place where noted.
# ---------------------------------------------------------------------------

def _block_caches(caches, a: int, t: int):
    """Transient caches for an (A, T) prompt block, shaped like the slot
    caches.  Left uninitialised: the block's prefill writes all T positions
    of every buffer, scales included."""
    return [
        tuple(torch.empty((a, buf.shape[1], t, *buf.shape[3:]), dtype=buf.dtype,
                          device=buf.device)
              for buf in layer)
        for layer in caches
    ]


def _block_prefill_merge(
    model: ChatTSModel,
    caches,  # slot caches, written in place
    tokens, cur_lens, temperature, top_p, budget,  # (B,) decode state, in place
    src,  # (N,) int64: block rows that land in a slot
    dst,  # (N,) int64: their slots
    embeds,  # (A, T, H) merged prompt embeddings
    seq_lens,  # (A,) int32
    adm_temp, adm_topp,  # (A,) f32
    adm_budget,  # (A,) int32: max_tokens of each block row
    generator: torch.Generator,
    act_int8: bool = False,
):
    """The admission's prompt block: one self-contained prefill over the
    (A, T) block, each landing row's prompt K/V (codes and scales in int8
    mode) copied into positions [0, T) of its slot, the first token of
    every block row sampled from its hidden state at seq_len - 1, and the
    landing rows merged into the decode state.  Returns the first tokens
    (A,) int32.  ``act_int8`` quantizes the prefill's projection inputs
    (``ServeEngine(prefill_act_int8=True)``); decode never does.  The port of
    ``_prefill_batch`` and ``_block_prefill_merge``."""
    a, t, _ = embeds.shape
    positions = torch.arange(t, dtype=torch.int32, device=embeds.device)[None].repeat(a, 1)
    kv_valid = positions < seq_lens[:, None]
    block = _block_caches(caches, a, t)
    hidden, _ = model.llm(embeds, positions, kv_caches=block, kv_valid=kv_valid,
                          kv_positions=positions, act_int8=act_int8)
    # Positions past the cache capacity are padding (prompt + max_tokens fit
    # the capacity), so a block wider than the cache copies what fits.
    n = min(t, caches[0][0].shape[2])
    for big, small in zip(caches, block):
        for bbuf, sbuf in zip(big, small):
            bbuf[dst, :, :n] = sbuf[src, :, :n]
    last = (seq_lens.long() - 1).clamp(min=0)[:, None, None].expand(a, 1, hidden.shape[-1])
    logits = model.compute_logits(hidden.gather(1, last))[:, 0]
    first = _sample(model.mesh, logits, generator, adm_temp, adm_topp)
    tokens[dst] = first[src]
    cur_lens[dst] = seq_lens[src]
    temperature[dst] = adm_temp[src]
    top_p[dst] = adm_topp[src]
    budget[dst] = adm_budget[src] - 1
    return first


def _sample(mesh, logits, generator, temperature, top_p) -> torch.Tensor:
    """``sample_per_slot``'s ids; under a mesh world rank 0's, broadcast."""
    return broadcast_from_driver(
        mesh, sampling.sample_per_slot(logits, generator, temperature, top_p), world=True)


def _decode_step(llm, caches, tokens, cur_lens, active, live, budget, temperature, top_p,
                 eos_ids, generator):
    """One decode step of every slot: each writes its new K/V at cur_len and
    attends the first cur_len + 1 positions.  Inactive slots attend one
    position and write at their stale cur_len, which admission keeps inside
    the capacity (prompt + max_tokens <= max_model_len).  Returns what
    ``_advance`` returns."""
    positions = cur_lens[:, None]
    hidden, _ = llm(
        llm.embed(tokens[:, None]), positions,
        kv_caches=caches, write_pos=positions,
        kv_lengths=torch.where(active, cur_lens + 1, 1),
    )
    return _advance(llm.compute_logits(hidden)[:, 0], tokens, cur_lens, live, budget,
                    temperature, top_p, eos_ids, generator, llm.mesh)


def _advance(logits, tokens, cur_lens, live, budget, temperature, top_p, eos_ids, generator,
             mesh=None):
    """Sample every slot's next token from its logits (B, V) and advance the
    live slots.  Returns (emitted (B,) int32, -1 where a slot did not emit;
    then the next tokens, cur_lens, budget and live)."""
    next_tok = _sample(mesh, logits, generator, temperature, top_p)
    emitted = torch.where(live, next_tok, -1)
    hit_eos = (next_tok[:, None] == eos_ids[None, :]).any(dim=1)
    budget = budget - live.to(budget.dtype)
    tokens = torch.where(live, next_tok, tokens)
    cur_lens = cur_lens + live.to(cur_lens.dtype)
    live = live & ~hit_eos & (budget > 0)
    return emitted, tokens, cur_lens, budget, live


def _decode_all_slots(model, chunk_size, caches, tokens, cur_lens, active, temperature,
                      top_p, eos_ids, budget, generator):
    """A decode round run eagerly: every active slot advances ``chunk_size``
    steps (the port of the reference's non-recent ``_decode_scan`` as a
    loop on the device), ``tokens``, ``cur_lens`` and ``budget`` written
    back in place.  Returns the one packed (B, chunk + 1) int32 array the
    host fetches: the emitted tokens, then the live flag."""
    live = active & (budget > 0)
    new, emitted = [tokens, cur_lens, budget], []
    for _ in range(chunk_size):
        emit, *new, live = _decode_step(model.llm, caches, new[0], new[1], active, live,
                                        new[2], temperature, top_p, eos_ids, generator)
        emitted.append(emit)
    for state, value in zip((tokens, cur_lens, budget), new):
        state.copy_(value)
    return torch.cat([torch.stack(emitted, dim=1), live[:, None].to(torch.int32)], dim=1)


class _DecodeStepGraph:
    """One decode step of every slot captured in a CUDA graph, over state
    tensors that never move: a round replays it ``chunk`` times, each replay
    writing its emitted tokens into the next column of ``emitted``.  Eager, a
    step's few thousand launches cost more host time than the card's work
    (PERF.md); a replay is one launch."""

    def __init__(self, model, chunk_size, caches, tokens, cur_lens, active, temperature,
                 top_p, eos_ids, budget, generator):
        b, dev = tokens.shape[0], tokens.device
        self.chunk_size = chunk_size
        self.state = (tokens, cur_lens, budget)
        self.active, self.budget = active, budget
        self.live = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.emitted = torch.zeros((b, chunk_size), dtype=torch.int32, device=dev)
        self.column = torch.zeros((b, 1), dtype=torch.int64, device=dev)
        args = (model.llm, caches, tokens, cur_lens, active, self.live, budget, temperature,
                top_p, eos_ids)

        def step():
            emit, *new = _decode_step(*args, generator)
            self.emitted.scatter_(1, self.column, emit[:, None])
            self.column += 1
            for state, value in zip((*self.state, self.live), new):
                state.copy_(value)

        # The warm-up step updates no state and draws from a generator of
        # its own; its K/V writes are the ones the round's first step makes.
        self.glue_calls: Dict[str, int] = {}
        self.graph, self.pool_bytes = graphs.capture(
            lambda: _decode_step(*args, torch.Generator(device=dev)),
            fused_glue.counting(step, self.glue_calls), generator)

    def round(self) -> torch.Tensor:
        """A pure decode round, as ``_decode_all_slots`` computes it."""
        torch.logical_and(self.active, self.budget > 0, out=self.live)
        self.column.zero_()
        for _ in range(self.chunk_size):
            self.graph.replay()
        return torch.cat([self.emitted, self.live[:, None].to(torch.int32)], dim=1)


def _block_admission_round(model, caches, tokens, cur_lens, active, temperature, top_p,
                           eos_ids, budget, src, dst, embeds, seq_lens, adm_temp, adm_topp,
                           adm_budget, generator, act_int8, decode_round):
    """One fused round: the admission's prompt block, then the decode chunk
    with the admitted rows live from its first step.  ``active`` (the
    engine's device mirror of the live slots) takes the landing rows in
    place, and ``decode_round()`` runs the chunk over the decode state, as a
    pure decode round does: from the decode step's graph on the card.
    Device liveness of the new rows uses the global EOS set, a subset of
    each request's host-side set (the host stays authoritative and drops
    over-decoded tokens).  Returns the packed (B, chunk + 2) result: the
    emitted tokens, the live flag, and the first tokens in rows [0, A)."""
    b = tokens.shape[0]
    first = _block_prefill_merge(model, caches, tokens, cur_lens, temperature, top_p,
                                 budget, src, dst, embeds, seq_lens, adm_temp, adm_topp,
                                 adm_budget, generator, act_int8)
    first_eos = (first[:, None] == eos_ids[None, :]).any(dim=1)
    active[dst] = (~first_eos & (adm_budget > 1))[src]
    packed = decode_round()
    first_b = torch.full((b,), -1, dtype=torch.int32, device=tokens.device)
    first_b[: first.shape[0]] = first
    return torch.cat([packed, first_b[:, None]], dim=1)


def _sample_admission_first(model: ChatTSModel, last_hidden, temperature, top_p,
                            generator: torch.Generator) -> torch.Tensor:
    """First token (A,) int32 of each admission row from its captured hidden
    state at seq_len - 1 (after the final norm; f32, holding values of the
    model's type)."""
    hidden = last_hidden.to(model.llm.embed_tokens.dtype)[:, None]
    logits = model.compute_logits(hidden)[:, 0]
    return _sample(model.mesh, logits, generator, temperature, top_p)


class _MixedInputs:
    """What a scan-sliced round reads besides the slots' decode state, at
    addresses that never move (one set per (a, npt), made on first use):
    the round's prompt slice (A, chunk, npt, H), the next step's span start
    and index (device scalars that each step advances), the admission's
    slots, real-row count and prompt lengths, the hidden states captured so
    far (A, H) f32, and the round's emitted tokens and live flags."""

    def __init__(self, b: int, a: int, npt: int, chunk_size: int, hdim: int, dtype, device):
        self.embeds = torch.zeros((a, chunk_size, npt, hdim), dtype=dtype, device=device)
        self.off = torch.zeros((), dtype=torch.int32, device=device)
        self.step = torch.zeros((1,), dtype=torch.int64, device=device)
        self.adm_slots = torch.zeros((a,), dtype=torch.int64, device=device)
        self.n_real = torch.zeros((), dtype=torch.int64, device=device)
        self.seq_lens = torch.zeros((a,), dtype=torch.int32, device=device)
        self.last_hidden = torch.zeros((a, hdim), dtype=torch.float32, device=device)
        self.live = torch.zeros((b,), dtype=torch.bool, device=device)
        self.emitted = torch.zeros((b, chunk_size), dtype=torch.int32, device=device)

    def load(self, embeds, o: int, adm_slots, n_real: int, seq_lens, last_hidden, active,
             budget) -> None:
        """Set the inputs of the round that consumes tokens [o, o + chunk *
        npt) of the admission's padded embeddings ``embeds`` (A, t_pad, H)."""
        c = self.embeds.shape[1] * self.embeds.shape[2]
        self.embeds.copy_(embeds[:, o:o + c].reshape(self.embeds.shape))
        self.off.fill_(o)
        self.step.zero_()
        self.adm_slots.copy_(adm_slots)
        self.n_real.fill_(n_real)
        self.seq_lens.copy_(seq_lens)
        self.last_hidden.copy_(last_hidden)
        torch.logical_and(active, budget > 0, out=self.live)

    def packed(self) -> torch.Tensor:
        """The round's (B, chunk + 1) int32 result: the emitted tokens (-1
        where a slot did not emit), then the live flag."""
        return torch.cat([self.emitted, self.live[:, None].to(torch.int32)], dim=1)


def _mixed_step(llm, npt: int, kv_limit: int, caches, tokens, cur_lens, active, temperature,
                top_p, eos_ids, budget, generator, inp: _MixedInputs):
    """One step of a scan-sliced round, the body of the reference's
    ``_mixed_step_all_slots`` scan: every slot advances one decode step as
    ``_decode_step`` does, and every admission row consumes the npt prompt
    tokens at ``inp.off`` in the same packed stream; the active rows write
    their decode K/V and the real admission rows their prompt span
    (``QwenModel.forward_mixed``).  Updates no state.  Returns what
    ``_advance`` returns (from ``inp.live``), then the hidden states (A, H)
    f32 at each row's position seq_len - 1, zeros where that position is
    not in this step."""
    b = tokens.shape[0]
    a, _, _, hdim = inp.embeds.shape
    pro_pos = inp.off + torch.arange(npt, dtype=torch.int32, device=tokens.device)
    dec_embeds = llm.embed(tokens)
    prompt = inp.embeds.index_select(1, inp.step).reshape(a * npt, hdim)
    x = torch.cat([dec_embeds, prompt.to(dec_embeds.dtype)])[None]
    positions = torch.cat([cur_lens, pro_pos.repeat(a)])[None]
    hidden = llm.forward_mixed(
        x, positions, b=b, a=a, npt=npt, kv_caches=caches, dec_rows=active,
        dec_kv_lengths=torch.where(active, cur_lens + 1, 1), adm_slots=inp.adm_slots,
        n_real=inp.n_real, adm_seq_lens=inp.seq_lens, span_start=inp.off, kv_limit=kv_limit)
    out = _advance(llm.compute_logits(hidden[0, :b, None])[:, 0], tokens, cur_lens, inp.live,
                   budget, temperature, top_p, eos_ids, generator, llm.mesh)
    captured = pro_pos[None, :] == (inp.seq_lens - 1)[:, None]  # (A, npt)
    grab = torch.where(captured[..., None], hidden[0, b:].reshape(a, npt, hdim).float(),
                       0.0).sum(dim=1)
    return (*out, grab)


def _mixed_step_in_place(llm, npt: int, kv_limit: int, caches, tokens, cur_lens, active,
                         temperature, top_p, eos_ids, budget, generator, inp: _MixedInputs):
    """One step of a scan-sliced round with ``tokens``, ``cur_lens``,
    ``budget`` and ``inp`` updated in place: its emitted tokens in column
    ``inp.step``, the captured hidden states added into ``inp.last_hidden``,
    the span start and the step advanced."""
    emit, *new, grab = _mixed_step(llm, npt, kv_limit, caches, tokens, cur_lens, active,
                                   temperature, top_p, eos_ids, budget, generator, inp)
    inp.emitted.index_copy_(1, inp.step, emit[:, None])
    for state, value in zip((tokens, cur_lens, budget, inp.live), new):
        state.copy_(value)
    inp.last_hidden += grab
    inp.off += npt
    inp.step += 1


def _mixed_round(model: ChatTSModel, chunk_size: int, npt: int, kv_limit: int, caches,
                 tokens, cur_lens, active, temperature, top_p, eos_ids, budget, generator,
                 inp: _MixedInputs) -> torch.Tensor:
    """One scan-sliced mixed round run eagerly, the port of
    ``_mixed_step_all_slots``: ``chunk_size`` steps of ``_mixed_step`` over
    the inputs ``inp.load`` set, the state updated in place (``tokens``,
    ``cur_lens``, ``budget``, ``inp.last_hidden``).  Off the card and on a
    gloo mesh; on the card ``_MixedStepGraph`` replays the same step, one
    graph per (a, npt, kv_limit).  Returns the packed (B, chunk + 1) int32
    result (``_MixedInputs.packed``)."""
    for _ in range(chunk_size):
        _mixed_step_in_place(model.llm, npt, kv_limit, caches, tokens, cur_lens, active,
                             temperature, top_p, eos_ids, budget, generator, inp)
    return inp.packed()


class _MixedStepGraph:
    """One step of a scan-sliced round captured in a CUDA graph for one
    (a, npt, kv_limit), over the slots' state and ``inp``: a round replays
    it ``chunk_size`` times and computes what ``_mixed_round`` computes.
    ``pool`` is the memory pool the engine's mixed graphs share."""

    def __init__(self, model, chunk_size, npt, kv_limit, caches, tokens, cur_lens, active,
                 temperature, top_p, eos_ids, budget, generator, inp, pool=None):
        self.chunk_size, self.inp = chunk_size, inp
        args = (model.llm, npt, kv_limit, caches, tokens, cur_lens, active, temperature,
                top_p, eos_ids, budget)
        # The warm-up step updates no state and draws from a generator of
        # its own; its K/V writes are the ones the round's first step makes.
        self.glue_calls: Dict[str, int] = {}
        self.graph, self.pool_bytes = graphs.capture(
            lambda: _mixed_step(*args, torch.Generator(device=tokens.device), inp),
            fused_glue.counting(lambda: _mixed_step_in_place(*args, generator, inp),
                                self.glue_calls), generator, pool)

    def round(self) -> torch.Tensor:
        for _ in range(self.chunk_size):
            self.graph.replay()
        return self.inp.packed()


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class ServeEngine:
    """Slot-based continuous-batching engine with a background step loop, on
    ``device`` (the card unless the caller asks for the CPU).  On a mesh
    every rank makes one: world rank 0 serves (``start``, ``submit``) and
    the others, of every dp group, call ``follow()``."""

    def __init__(
        self,
        params_or_model: Union[ChatTSModel, Mapping[str, Any]],
        cfg: ChatTSConfig,
        processor: ChatTSProcessor,
        *,
        device="cuda",
        max_batch_size: int = 8,
        max_model_len: int = 6144,  # reference serving default ~6000
        cache_dtype=torch.bfloat16,
        decode_chunk: int = 8,
        eos_token_ids: Sequence[int] = (),
        seed: int = 0,
        fuse: bool = True,
        prefill_chunk: Optional[int] = None,
        prefill_act_int8: bool = False,
        admission_bucket: int = 8,
        admission_binning: bool = True,
        block_early_emit: bool = False,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # The loop thread sets this device, which needs an index.
            self.device = torch.device("cuda", torch.cuda.current_device())
        if isinstance(params_or_model, ChatTSModel):
            model = params_or_model.to(self.device)
        else:
            model = from_jax_params(params_or_model, cfg, self.device)
        if fuse:
            model = maybe_fuse(model)
        self.model = model.eval()
        self.mesh = infer_mesh(model)
        self.is_driver = self.mesh is None or (self.mesh.is_driver and self.mesh.dp_index == 0)
        self.cfg = cfg
        self.processor = processor
        # Pin the series-count bucket, as the reference does, so admission
        # batches of any size pad their series to one count.
        processor.series_count_floor = max(
            processor.series_count_floor, 2 * max_batch_size
        )
        self.max_batch_size = max_batch_size
        self.max_model_len = max_model_len
        self.decode_chunk = decode_chunk
        # Prompts longer than this always admit through the mixed path, even
        # with no slot live, and never as one block.
        self.prefill_chunk = prefill_chunk
        # int8 activations for every admission's prompt block (B5 for int4
        # weights); decode stays in the model's type.
        self.prefill_act_int8 = prefill_act_int8
        # Max rows per block admission wave; overflow waits for the next.
        self._a_bucket_cfg = admission_bucket
        # Length-classed admission: each wave takes only requests from the
        # OLDEST waiting request's length class (pow2 ceiling of the exact
        # token count, min 256), so rows of one wave stay within 2x of each
        # other's length.
        self.admission_binning = admission_binning
        # Early first-token emission: block admissions run prefill-only
        # rounds, so first tokens stream one round earlier.
        self.block_early_emit = block_early_emit
        # Admissions whose padded prompt block fits a*t <= this budget run
        # as one block round; larger ones take the scan-sliced path.
        self.block_token_budget = 8192
        self._a_bucket = min(self._a_bucket_cfg, max_batch_size)
        self.eos_token_ids = tuple(eos_token_ids)
        self.pad_id = processor.pad_token_id

        self.cache_dtype = cache_dtype
        b = max_batch_size
        dev = self.device
        # State is made in inference mode: the loop thread updates it in
        # place, in inference mode too.
        with torch.inference_mode():
            self._eos_dev = torch.tensor(list(self.eos_token_ids) or [-1],
                                         dtype=torch.int32, device=dev)
            self.caches = kv_cache.allocate(cfg.llm, b, max_model_len, cache_dtype, dev,
                                            kv_heads=self.model.llm.kv_heads)
            self.tokens = torch.zeros((b,), dtype=torch.int32, device=dev)
            self.cur_lens = torch.zeros((b,), dtype=torch.int32, device=dev)
            self.temperature = torch.zeros((b,), dtype=torch.float32, device=dev)
            self.top_p = torch.ones((b,), dtype=torch.float32, device=dev)
            self.budget = torch.zeros((b,), dtype=torch.int32, device=dev)
            # Device mirror of live_host, uploaded only when it changes.
            self._active_dev = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        # These state tensors never move: rounds update them in place.  On
        # the card every decode chunk (of a pure decode round or a fused
        # block round) replays a CUDA graph of one step over them, captured
        # in the first, and every scan-sliced round a graph of one mixed
        # step for its (a, npt, kv_limit) over them and its inputs (one set
        # per (a, npt)), the mixed graphs in one memory pool.
        self._decode_graph: Optional[_DecodeStepGraph] = None
        self._mixed_inputs: Dict[tuple, _MixedInputs] = {}
        self._mixed_graphs: Dict[tuple, _MixedStepGraph] = {}
        self._mixed_pool = None
        # Rounds run from a graph and run eagerly, by kind ("decode",
        # "block", "mixed"); each capture's kind, key, seconds and pool bytes.
        self.graph_rounds: Dict[str, int] = collections.Counter()
        self.eager_rounds: Dict[str, int] = collections.Counter()
        self.graph_captures: List[Dict[str, Any]] = []
        # Why rounds run eagerly, or None when they replay graphs.
        self.eager_decode_reason: Optional[str] = None
        if self.device.type != "cuda":
            self.eager_decode_reason = "no CUDA graphs off the card"
        elif self.mesh is not None and self.mesh.backend != "nccl":
            self.eager_decode_reason = (f"{self.mesh.backend} collectives cannot be captured "
                                        f"in a CUDA graph")
            print(f"[ServeEngine] rounds run eagerly: {self.eager_decode_reason}",
                  file=sys.stderr)
        # Under tensor parallelism: the time of the driver's last plan, and
        # whether the followers were told to stop; an error that ended the
        # driver's loop (the ranks cannot be brought back into step).
        self._last_plan_s = time.perf_counter()
        self._followers_stopped = False
        self.loop_error: Optional[str] = None
        # The scan-sliced admission whose first tokens are to be sampled.
        self._finalizing: Optional[Dict[str, Any]] = None

        self.slots: List[Optional[Request]] = [None] * b
        self.live_host = np.zeros((b,), bool)
        self._active_key: Optional[bytes] = None
        # The admission in flight: a block one (mode "block"), dispatched as
        # the next round, or a scan-sliced one (mode "mixed"), whose prompt
        # the next rounds consume.
        self._pending_mixed: Optional[Dict[str, Any]] = None

        self.waiting = _WaitQueue()
        # After a round frees k slots, wait up to this long for k
        # replacement requests before dispatching the next round, so a
        # closed-loop client's replacement joins this admission wave.
        self.admit_grace_s = 0.010
        self._finished_total = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        # Metrics.
        self.total_requests = 0
        self.total_output_tokens = 0  # updated at request completion
        self.streamed_tokens = 0  # updated every round
        # Block and scan-sliced admission rounds run, as the reference counts.
        self.mixed_rounds_run = 0
        self.metrics = MetricsAggregator()
        # The span record, a ring buffer: one dict per engine-loop round,
        # {kind, admit_s, round_s, live, a, rows, emitted, gap_s}, the span
        # fields and the device stamps (module docstring).  gap_s is host
        # time since the previous round ended (loop starvation).
        self.round_log: "collections.deque" = collections.deque(maxlen=4096)
        # stats() snapshots the deques from caller threads while the loop
        # appends.
        self._round_log_lock = threading.Lock()
        # stats()["slow_events"] counts the spans this long or longer.
        self.slow_event_s = 1.0
        self._last_round_end = time.perf_counter()
        self._span = SpanTimer()
        # Span seconds of the round in flight, and of the admission and idle
        # phases that go into the next round's entry.
        self._round_spans: Dict[str, float] = {}
        self._carry: Dict[str, float] = {}
        # On the card the loop's DeviceClock; the (start, end) marks of the
        # work launched between rounds and of the embeddings, since the last
        # round's launch; that round's (start, end, those two lists).
        self._clock: Optional[DeviceClock] = None
        self._dev_pending: tuple = ([], [])
        self._dev_round: Optional[tuple] = None
        # Each admitted request's wait in the queue (seconds), and the
        # admitted requests by route.
        self._queue_waits: "collections.deque" = collections.deque(maxlen=4096)
        self._routes: Dict[str, int] = collections.Counter()

    # -- public API --------------------------------------------------------

    def warmup(
        self,
        prefill_buckets: Sequence[int] = (128, 256, 512),
        series_per_request: int = 2,
        series_len: int = 512,
    ) -> None:
        """Run the admission shapes of real traffic once, so the first real
        requests find the kernels built and the allocator warm: per bucket,
        monolithic bursts of max_batch_size, 4, 2 and 1 rows, then every
        block-admission row count next to a decoding runner.  Every
        admission prefills as real ones do, with ``prefill_act_int8`` when
        it is set.  The scan-sliced round, whose kernels these rounds already
        load, is not forced: on the card its graph is captured in the first
        round of each (a, npt, kv_limit).
        Failures are printed, not raised, as in the reference."""
        self.start()
        for bucket in sorted(prefill_buckets):
            # ~1 token per short word; leave headroom for the template and
            # the TS placeholders so the padded length lands in this bucket.
            words = " ".join("warm" for _ in range(max(1, bucket - 64)))
            holes = " ".join(encoding.TS_PAIR for _ in range(series_per_request))
            prompt = f"{words} {holes}"
            bursts = [self.max_batch_size]
            if self.max_batch_size > 8:
                bursts.append(4)
            if self.max_batch_size > 2:
                bursts.append(2)
            if self.max_batch_size > 1:
                bursts.append(1)
            for burst in bursts:
                reqs = []
                for _ in range(burst):
                    series = [np.sin(np.arange(float(series_len)))
                              for _ in range(series_per_request)]
                    req = Request(prompt, series,
                                  SamplingParams(max_tokens=self.decode_chunk + 2,
                                                 temperature=0.0))
                    self.submit(req)
                    reqs.append(req)
                deadline = time.time() + 600
                for req in reqs:
                    while req.finished_s is None and req.error is None:
                        if time.time() > deadline:
                            print(f"[warmup] bucket {bucket} timed out", file=sys.stderr)
                            return
                        time.sleep(0.01)
                    if req.error:
                        print(f"[warmup] bucket {bucket} failed: {req.error}",
                              file=sys.stderr)
        self._warmup_mixed(prefill_buckets, series_per_request, series_len)

    def _warmup_mixed(self, prefill_buckets, series_per_request, series_len):
        """Keep one runner request decoding and admit a wave of each block
        row count per bucket, so the block rounds run once, as the
        reference does."""
        holes = " ".join(encoding.TS_PAIR for _ in range(series_per_request))

        def mkseries():
            return [np.sin(np.arange(float(series_len))) for _ in range(series_per_request)]

        # The runner's prompt + max_tokens must pass the max_model_len check
        # for any engine capacity.
        budget = min(4096, self.max_model_len - 64
                     - 64 * max(1, series_per_request)
                     - series_per_request * series_len // 8)
        budget = max(budget, 4 * self.decode_chunk)
        deadline = time.time() + 600
        runner_box: List[Optional[Request]] = [None]

        def ensure_runner() -> bool:
            """(Re)start the runner if it finished or failed."""
            r = runner_box[0]
            if r is not None and r.finished_s is None and r.error is None:
                return True
            r = Request(f"runner {holes}", mkseries(),
                        SamplingParams(max_tokens=budget, temperature=0.0))
            runner_box[0] = r
            self.submit(r)
            while not r.output_tokens:
                if r.error:
                    print(f"[warmup] mixed runner rejected: {r.error}", file=sys.stderr)
                    return False
                if time.time() > deadline:
                    print("[warmup] mixed runner timed out", file=sys.stderr)
                    return False
                time.sleep(0.01)
            return True

        def wave(bucket: int, rows: int) -> bool:
            """One wave of ``rows`` requests of the bucket next to the runner;
            False when warm-up has to stop."""
            if not ensure_runner():
                return False
            words = " ".join("warm" for _ in range(max(1, bucket - 64)))
            reqs = [Request(f"{words} {holes}", mkseries(),
                            SamplingParams(max_tokens=2, temperature=0.0))
                    for _ in range(rows)]
            for req in reqs:
                self.submit(req)
            for req in reqs:
                while req.finished_s is None and req.error is None:
                    if time.time() > deadline:
                        print(f"[warmup] mixed bucket {bucket} timed out", file=sys.stderr)
                        if runner_box[0] is not None:
                            runner_box[0].cancel()
                        return False
                    time.sleep(0.01)
                if req.error:
                    print(f"[warmup] mixed bucket {bucket} failed: {req.error}",
                          file=sys.stderr)
            return True

        for bucket in sorted(prefill_buckets):
            fams = {self._block_family(n) for n in range(1, self._a_bucket + 1)}
            for rows in sorted(fams, reverse=True):
                if not wave(bucket, rows):
                    return
        runner = runner_box[0]
        if runner is None:
            return
        runner.cancel()
        while runner.finished_s is None and runner.error is None:
            if time.time() > deadline:
                return
            time.sleep(0.01)

    def submit(self, request: Request) -> Request:
        if not self.is_driver:
            raise RuntimeError("a follower rank takes no requests: submit to world rank 0 "
                               "(tp rank 0 of dp group 0)")
        self.total_requests += 1
        request.submitted_s = time.perf_counter()
        if self.loop_error is not None:
            self._fail(request, f"the engine loop ended: {self.loop_error}")
            return request
        self.waiting.put(request)
        self._wake.set()
        return request

    def generate_sync(
        self, prompt: str, timeseries: Sequence[np.ndarray] = (),
        params: Optional[SamplingParams] = None, timeout: float = 600.0,
    ) -> Request:
        req = Request(prompt, [np.asarray(t) for t in timeseries],
                      params or SamplingParams())
        self.submit(req)
        deadline = time.time() + timeout
        while req.finished_s is None and req.error is None:
            if time.time() > deadline:
                raise TimeoutError(f"request {req.request_id} timed out")
            time.sleep(0.005)
        if req.error:
            raise RuntimeError(req.error)
        return req

    def start(self):
        if not self.is_driver:
            raise RuntimeError("a follower rank runs follow(), not the engine loop")
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def stop(self):
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        elif self.mesh is not None and self.is_driver and self.loop_error is None:
            self._stop_followers()  # driven by hand, with no loop to tell them

    # -- tensor parallelism -------------------------------------------------

    def _run(self, op: str, *args):
        """Run the device op ``_op_<op>(*args)``; under a mesh the driver
        broadcasts it as a plan first, so every rank runs it.  On the card
        world rank 0 marks the op's start and end: a round's or a monolithic
        admission's for its entry, which also takes the marks of the work
        launched since the last one; any other op's as such work."""
        if self.mesh is not None:
            broadcast_from_driver(self.mesh, (op, args), world=True)
            self._last_plan_s = time.perf_counter()
        fn = getattr(self, "_op_" + op)
        clock = self._clock
        if clock is None or op == "idle":
            return fn(*args)
        start = clock.mark()
        if op in ("round", "mono"):
            pre, embed = self._dev_pending
            self._dev_pending = ([], [])
            out = fn(*args)
            self._dev_round = (start, clock.mark(), pre, embed)
            return out
        out = fn(*args)
        self._dev_pending[0].append((start, clock.mark()))
        return out

    def _stop_followers(self) -> None:
        if not self._followers_stopped:
            self._followers_stopped = True
            broadcast_from_driver(self.mesh, ("stop", ()), world=True)

    def follow(self) -> None:
        """A follower rank's loop: run the driver's plans until it stops."""
        if self.is_driver:
            raise RuntimeError("follow() is for the ranks other than world rank 0")
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            while True:
                op, args = broadcast_from_driver(self.mesh, None, world=True)
                if op == "stop":
                    return
                getattr(self, "_op_" + op)(*args)

    def _op_idle(self) -> None:
        """The idle driver's heartbeat."""

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- engine loop -------------------------------------------------------

    def _log_round(self, **entry) -> None:
        with self._round_log_lock:
            self.round_log.append(entry)

    def _device_fields(self) -> Dict[str, Optional[float]]:
        """The device stamps of the round or monolithic admission last
        launched, read after its fetch (every mark is then complete); None
        off the card."""
        marks, self._dev_round = self._dev_round, None
        if marks is None:
            return dict(dev_start=None, dev_end=None, pre_dev_s=None, embed_dev_s=None)
        start, end, pre, embed = marks
        seconds = DeviceClock.seconds
        out = dict(dev_start=DeviceClock.host_s(start), dev_end=DeviceClock.host_s(end),
                   pre_dev_s=sum(seconds(a, b) for a, b in pre),
                   embed_dev_s=sum(seconds(a, b) for a, b in embed))
        self._clock.release([start, end, *(m for pair in pre + embed for m in pair)])
        return out

    def _anchor(self) -> None:
        """Let the device clock re-take its anchor; where the stream is
        empty."""
        if self._clock is not None:
            self._clock.anchor()

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def _tensor(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    def _token_class(self, req: Request) -> int:
        """Cached pow2 (>= 256) length class of a request's exact prompt
        token count; -1 when the prompt fails to encode."""
        if req.token_class is None:
            try:
                n = self.processor.count_tokens(req.prompt, req.timeseries)
                c = 256
                while c < n:
                    c *= 2
                req.token_class = c
            except Exception:
                req.token_class = -1
        return req.token_class

    def _select_candidates(self, n_free: int) -> List[Request]:
        """Pick the next admission wave from the wait queue: FIFO, except
        that with admission_binning the wave takes only requests sharing the
        OLDEST request's length class.  Cancelled requests are finished and
        dropped; a malformed oldest request admits alone."""
        live: List[Request] = []
        drop: List[Request] = []
        for req in self.waiting.snapshot():
            if req.cancelled:
                req.finish_reason = "cancelled"
                req.finished_s = time.perf_counter()
                req.stream_queue.put(None)
                drop.append(req)
            else:
                live.append(req)
        if drop:
            self.waiting.remove(drop)
        if not live:
            return []
        if self.admission_binning and len(live) > 1:
            head_cls = self._token_class(live[0])
            if head_cls == -1:
                chosen = [live[0]]  # malformed: isolate
            else:
                chosen = [r for r in live if self._token_class(r) == head_cls][:n_free]
        else:
            chosen = live[:n_free]
        self.waiting.remove(chosen)
        now = time.perf_counter()
        for req in chosen:
            req.admitted_s = now
        return chosen

    def _fail(self, req: Request, message: str) -> None:
        req.error = message
        req.stream_queue.put(None)

    def _admit(self) -> None:
        """Admit up to len(free slots) waiting requests with one processor
        pass and one prefill.  A request that fails processing is isolated
        by probing each request alone; one whose prompt + max_tokens exceeds
        max_model_len is rejected without failing the wave."""
        if self._pending_mixed is not None:
            return  # an admission is in flight; new ones wait
        free = self._free_slots()
        if not free:
            return
        with self._span(self._carry, "select_s"):
            candidates = self._select_candidates(len(free))
        if not candidates:
            return

        def process(reqs):
            with self._span(self._carry, "process_s"):
                return self.processor([r.prompt for r in reqs],
                                      [ts for r in reqs for ts in r.timeseries])

        try:
            batch = process(candidates)
        except Exception:
            kept: List[Request] = []
            for req in candidates:
                try:
                    process([req])
                    kept.append(req)
                except Exception as err:
                    self._fail(req, f"{type(err).__name__}: {err}")
            candidates = kept
            if not candidates:
                return
            batch = process(candidates)
        admitted: List[Request] = []
        keep_rows: List[int] = []
        for i, req in enumerate(candidates):
            n_tok = int(batch.seq_lens[i])
            if n_tok + req.params.max_tokens > self.max_model_len:
                self._fail(req, f"ValueError: prompt ({n_tok}) + max_tokens "
                                f"({req.params.max_tokens}) exceeds max_model_len "
                                f"{self.max_model_len}")
                continue
            req.prompt_tokens = n_tok
            admitted.append(req)
            keep_rows.append(i)
        if not admitted:
            return
        want_mixed = self.live_host.any() or (
            self.prefill_chunk is not None and batch.input_ids.shape[1] > self.prefill_chunk)
        mode = "mono"
        if want_mixed:
            # While slots decode (or for a prompt above prefill_chunk), an
            # admission takes the block or the scan-sliced round instead of
            # a monolithic prefill that stalls decode.  It is capped at the
            # admission bucket; overflow returns to the FRONT of the queue.
            if len(admitted) > self._a_bucket:
                self.waiting.requeue(admitted[self._a_bucket:])
                admitted = admitted[: self._a_bucket]
                keep_rows = keep_rows[: len(admitted)]
            # Both pack exactly the admitted rows.
            if keep_rows != list(range(batch.input_ids.shape[0])):
                batch = process(admitted)
                keep_rows = list(range(len(admitted)))
            t = batch.input_ids.shape[1]
            if self._block_eligible(len(admitted), t):
                mode = "block"
            elif self._mixed_plan(len(admitted), t)[3] <= self.max_model_len:
                # The scan-sliced round writes the padded prompt into the
                # slots: it must fit the cache, else the admission is
                # monolithic (round kind "mono").
                mode = "mixed"
        try:
            with self._span(self._carry, "stage_s"):
                self._prefill_requests(admitted, free[: len(admitted)], batch, keep_rows, mode)
        except Exception as err:
            for req in admitted:
                self._fail(req, f"{type(err).__name__}: {err}")
            if self.mesh is not None:
                raise  # the ranks may have parted mid-step: the loop ends

    def _prefill_requests(self, reqs: List[Request], slots: List[int], batch,
                          keep_rows: List[int], mode: str = "mono") -> None:
        """Admit the rows as ``_admit`` routed them: ``"mono"`` prefills
        them now; ``"block"`` and ``"mixed"`` stage a block or a scan-sliced
        admission for the next rounds."""
        with self._round_log_lock:
            for req in reqs:
                req.route = mode
                self._routes[mode] += 1
                if req.submitted_s is not None and req.admitted_s is not None:
                    self._queue_waits.append(req.admitted_s - req.submitted_s)
        if mode == "block":
            self._start_block_admission(reqs, slots, keep_rows, batch)
            return
        if mode == "mixed":
            self._start_mixed_admission(reqs, slots, keep_rows, batch)
            return
        kb = batch.input_ids.shape[0]
        mono_t0 = time.perf_counter()
        spans: Dict[str, float] = {}
        # Every processed row computes (rejected over-long rows included);
        # only the admitted rows land in a slot.
        temp = np.zeros((kb,), np.float32)
        topp = np.ones((kb,), np.float32)
        budget = np.zeros((kb,), np.int32)
        for req, row in zip(reqs, keep_rows):
            temp[row] = req.params.temperature
            topp[row] = req.params.top_p
            budget[row] = req.params.max_tokens
        with self._span(spans, "dispatch_s"):
            first = self._run("mono", batch, keep_rows, slots, temp, topp, budget)
        with self._span(spans, "wait_s"):
            first = first.cpu().numpy()
        self._anchor()
        device = self._device_fields()
        with self._span(spans, "apply_s"):
            self._finalize_admission(reqs, slots, keep_rows, first)
        # Monolithic admissions run outside the round loop and block on the
        # first-token fetch; they are logged as their own round kind.
        self._log_round(kind="mono", admit_s=0.0, round_s=time.perf_counter() - mono_t0,
                        live=0, a=len(reqs), rows=kb, emitted=len(reqs), gap_s=0.0,
                        **{f: spans.get(f, 0.0) for f in SPANS}, **device)

    def _op_mono(self, batch, keep_rows, slots, temp, topp, budget) -> torch.Tensor:
        """A monolithic admission's prefill: the first tokens (A,)."""
        return _block_prefill_merge(
            self.model, self.caches, self.tokens, self.cur_lens, self.temperature,
            self.top_p, self.budget,
            self._tensor(keep_rows, torch.int64), self._tensor(slots, torch.int64),
            self._embed(batch), self._tensor(batch.seq_lens, torch.int32),
            self._tensor(temp, torch.float32), self._tensor(topp, torch.float32),
            self._tensor(budget, torch.int32), self.generator, self.prefill_act_int8)

    def _embed(self, batch) -> torch.Tensor:
        """Merged prompt embeddings (A, T, H) of a processed batch: the TS
        encoder and the merge, marked on the card."""
        with self._span(self._carry, "embed_s"):
            start = self._clock.mark() if self._clock is not None else None
            out = self.model.input_embeddings(
                self._tensor(batch.input_ids, torch.int64),
                self._tensor(batch.ts_values, torch.float32),
                self._tensor(batch.ts_mask, torch.float32),
                self._tensor(batch.scatter_seq, torch.int64),
                self._tensor(batch.scatter_tok, torch.int64),
            )
            if start is not None:
                self._dev_pending[1].append((start, self._clock.mark()))
        return out

    def _finalize_admission(self, reqs, slots, keep_rows, first_host,
                            device_synced: bool = True) -> None:
        """Host bookkeeping for an admission's first tokens: the slot
        records, live_host and the streams are updated, and a request whose
        first token ends it (EOS, max_tokens 1, cancelled) finishes.  With
        ``device_synced`` the device already merged the rows into the decode
        state; otherwise (a scan-sliced admission) the rows that go live are
        written into it here, one indexed assignment an array, in place."""
        now = time.perf_counter()
        going_live = []
        for req, slot, row in zip(reqs, slots, keep_rows):
            tok = int(first_host[row])
            req.first_token_s = now
            eos = set(self.eos_token_ids) | set(req.params.stop_token_ids)
            self.slots[slot] = req
            if req.cancelled:
                self._finish(slot, "cancelled")
                continue
            if tok in eos or req.params.max_tokens <= 1:
                if tok not in eos:
                    req.output_tokens.append(tok)
                    req.stream_queue.put([tok])
                self._finish(slot, "stop" if tok in eos else "length")
                continue
            req.output_tokens.append(tok)
            req.stream_queue.put([tok])
            self.live_host[slot] = True
            going_live.append((slot, tok, req))
        if device_synced or not going_live:
            return
        self._run("go_live", [slot for slot, _, _ in going_live],
                  [tok for _, tok, _ in going_live],
                  [r.prompt_tokens for _, _, r in going_live],
                  [r.params.temperature for _, _, r in going_live],
                  [r.params.top_p for _, _, r in going_live],
                  [r.params.max_tokens - 1 for _, _, r in going_live])

    def _op_go_live(self, slots, tokens, cur_lens, temperature, top_p, budget) -> None:
        """Write the rows of a scan-sliced admission that go live into the
        decode state, one indexed assignment an array, in place."""
        rows = self._tensor(slots, torch.int64)
        for state, values, dtype in ((self.tokens, tokens, torch.int32),
                                     (self.cur_lens, cur_lens, torch.int32),
                                     (self.temperature, temperature, torch.float32),
                                     (self.top_p, top_p, torch.float32),
                                     (self.budget, budget, torch.int32)):
            state[rows] = self._tensor(values, dtype)

    def _mixed_plan(self, n_reqs: int, t: int):
        """Size a scan-sliced admission, as the reference does: (row family
        a, prompt tokens a row per step npt, a row's tokens per round c,
        padded prompt length t_pad).  a is the smallest of 1, 2, 4 and the
        admission bucket that covers the rows; npt takes the whole prompt in
        one round unless capped so that the packed rows B + a * npt stay
        within 512, or by ``MIXED_NPT``."""
        a = (1 if n_reqs <= 1 else 2 if n_reqs <= 2
             else 4 if n_reqs <= 4 else self._a_bucket)
        npt_cap = max(8, (512 - self.max_batch_size) // a)
        npt = min(-(-t // self.decode_chunk), npt_cap, MIXED_NPT)
        c = self.decode_chunk * npt
        t_pad = -(-t // c) * c
        return a, npt, c, t_pad

    def _block_family(self, n_reqs: int) -> int:
        """The reference's padded row count for an n-row block admission
        ({1,2,3,4,6,8[,10,12]} capped at the admission bucket).  The port
        computes no pad rows, but sizes the eligibility rule by this count,
        so both engines take the same path for the same admission."""
        for f in (1, 2, 3, 4, 6, 8, 10, 12):
            if n_reqs <= f < self._a_bucket:
                return f
        return self._a_bucket

    def _block_eligible(self, n_reqs: int, t: int) -> bool:
        """Whether an admission takes the block round: the padded block fits
        the token budget and the prompt fits the cache.  A prompt above
        ``prefill_chunk`` never does."""
        if self.prefill_chunk is not None and t > self.prefill_chunk:
            return False
        a = self._block_family(n_reqs)
        return a * t <= self.block_token_budget and t <= self.max_model_len

    def _start_mixed_admission(self, reqs, slots, keep_rows, batch) -> None:
        """Stage a scan-sliced admission: the merged prompt embeddings are
        computed once, padded with zeros to (a, t_pad); each following round
        consumes ``decode_chunk * npt`` tokens of every row.  The slots are
        reserved; they go live with the first token."""
        kb, t = batch.input_ids.shape
        a, npt, _, t_pad = self._mixed_plan(len(reqs), t)
        if kb != len(reqs) or keep_rows != list(range(kb)) or kb > a:
            raise RuntimeError(f"a mixed admission packs exactly its {len(reqs)} "
                               f"admitted rows, not {kb}")
        seq_lens = np.zeros((a,), np.int32)  # 0 for pad rows: nothing captured
        adm_slots = np.zeros((a,), np.int64)  # pad rows read slot 0, write nothing
        temp = np.zeros((a,), np.float32)
        topp = np.ones((a,), np.float32)
        for req, slot, row in zip(reqs, slots, keep_rows):
            seq_lens[row] = req.prompt_tokens
            adm_slots[row] = slot
            temp[row] = req.params.temperature
            topp[row] = req.params.top_p
            self.slots[slot] = req
        self._run("stage_mixed", batch, slots, keep_rows, a, npt, t_pad, seq_lens, adm_slots,
                  temp, topp)
        self._pending_mixed["reqs"] = reqs

    def _op_stage_mixed(self, batch, slots, keep_rows, a, npt, t_pad, seq_lens, adm_slots,
                        temp, topp) -> None:
        kb, t = batch.input_ids.shape
        embeds = F.pad(self._embed(batch), (0, 0, 0, t_pad - t, 0, a - kb))
        self._pending_mixed = {
            "mode": "mixed", "slots": slots, "keep_rows": keep_rows,
            "embeds": embeds, "o": 0, "t_pad": t_pad, "npt": npt, "n_real": kb,
            "adm_slots": self._tensor(adm_slots, torch.int64),
            "seq_lens": self._tensor(seq_lens, torch.int32),
            "temp": self._tensor(temp, torch.float32),
            "topp": self._tensor(topp, torch.float32),
            "last_hidden": torch.zeros((a, embeds.shape[-1]), dtype=torch.float32,
                                       device=self.device),
        }

    def _start_block_admission(self, reqs, slots, keep_rows, batch) -> None:
        """Stage a block admission: merged prompt embeddings computed now,
        the prompt block dispatched as the next round.  The slots are
        reserved; they go live with the first token."""
        kb = batch.input_ids.shape[0]
        if kb != len(reqs) or keep_rows != list(range(kb)):
            raise RuntimeError(f"a block admission packs exactly its {len(reqs)} "
                               f"admitted rows, not {kb}")
        for req, slot in zip(reqs, slots):
            self.slots[slot] = req
        self._run("stage_block", batch, slots, keep_rows,
                  [r.params.temperature for r in reqs], [r.params.top_p for r in reqs],
                  [r.params.max_tokens for r in reqs])
        self._pending_mixed["reqs"] = reqs

    def _op_stage_block(self, batch, slots, keep_rows, temp, topp, budget) -> None:
        self._pending_mixed = {
            "mode": "block", "slots": slots, "keep_rows": keep_rows,
            "embeds": self._embed(batch),
            "src": self._tensor(keep_rows, torch.int64),
            "dst": self._tensor(slots, torch.int64),
            "seq_lens": self._tensor(batch.seq_lens, torch.int32),
            "temp": self._tensor(temp, torch.float32),
            "topp": self._tensor(topp, torch.float32),
            "budget": self._tensor(budget, torch.int32),
        }

    def _dispatch_block(self):
        st = self._pending_mixed
        self._pending_mixed = None
        self.mixed_rounds_run += 1
        adm = (st["src"], st["dst"], st["embeds"], st["seq_lens"], st["temp"],
               st["topp"], st["budget"], self.generator, self.prefill_act_int8)
        rows = st["embeds"].shape[0]
        if self.block_early_emit:
            first = _block_prefill_merge(
                self.model, self.caches, self.tokens, self.cur_lens, self.temperature,
                self.top_p, self.budget, *adm)
            return ("block_pre", first, st, len(st["slots"]), rows)
        packed = _block_admission_round(
            self.model, self.caches, self.tokens, self.cur_lens, self._active_device(),
            self.temperature, self.top_p, self._eos_dev, self.budget, *adm,
            decode_round=lambda: self._decode_round("block"))
        self._active_key = None  # the round made the landing rows live on the device
        return ("block", packed, st, len(st["slots"]), rows)

    def _dispatch_mixed(self):
        """One scan-sliced round: every slot advances ``decode_chunk`` steps
        and the admission consumes ``decode_chunk * npt`` tokens a row,
        attending a prefix that steps by 512 positions.  On the card the
        round replays the graph of one mixed step for its (a, npt,
        kv_limit), captured in the first round with that key; off the card,
        or on a gloo mesh, the same step runs eagerly.  The round's prompt
        slice and offsets go into the inputs for its (a, npt) first.  The
        round that consumes the last tokens clears the admission, so the
        next one can be staged after it; its first tokens are sampled in
        ``_complete_round``."""
        st = self._pending_mixed
        npt, o = st["npt"], st["o"]
        a, _, hdim = st["embeds"].shape
        c = self.decode_chunk * npt
        kv_limit = min(self.max_model_len, -(-min(o + c, st["t_pad"]) // 512) * 512)
        inp = self._mixed_inputs.get((a, npt))
        if inp is None:
            inp = self._mixed_inputs[(a, npt)] = _MixedInputs(
                self.max_batch_size, a, npt, self.decode_chunk, hdim, st["embeds"].dtype,
                self.device)
        active = self._active_device()
        inp.load(st["embeds"], o, st["adm_slots"], st["n_real"], st["seq_lens"],
                 st["last_hidden"], active, self.budget)
        args = (self.model, self.decode_chunk, npt, kv_limit, self.caches, self.tokens,
                self.cur_lens, active, self.temperature, self.top_p, self._eos_dev,
                self.budget, self.generator, inp)
        if self.eager_decode_reason is not None:
            packed = _mixed_round(*args)
            self._count_round(self.eager_rounds, "mixed")
        else:
            key = (a, npt, kv_limit)
            graph = self._mixed_graphs.get(key)
            if graph is None:
                if self._mixed_pool is None:
                    self._mixed_pool = torch.cuda.graph_pool_handle()
                start = time.perf_counter()
                graph = self._mixed_graphs[key] = _MixedStepGraph(*args, pool=self._mixed_pool)
                self._log_capture("mixed", key, graph, time.perf_counter() - start)
            packed = graph.round()
            self._count_round(self.graph_rounds, "mixed")
        st["last_hidden"].copy_(inp.last_hidden)
        st["o"] = o + c
        self.mixed_rounds_run += 1
        finalize = None
        if st["o"] >= st["t_pad"]:
            finalize = self._finalizing = st
            self._pending_mixed = None
        return ("mixed", packed, finalize, a, a * npt)

    def _complete_round(self, handle) -> None:
        """Fetch the dispatched round's result (the one host sync of the
        round) and apply it."""
        kind, packed, finalize = handle[0], handle[1], handle[2]
        with self._span(self._round_spans, "wait_s"):
            arr = packed.cpu().numpy()
        self._anchor()
        with self._span(self._round_spans, "apply_s"):
            if kind == "block_pre":
                # The fetched array is the (A,) first tokens; the admitted rows
                # decode in the next round.
                self._finalize_admission(finalize["reqs"], finalize["slots"],
                                         finalize["keep_rows"], arr)
                return
            if kind == "block":
                # (B, chunk + 2): emitted | live | first tokens.  Finalize first:
                # the round already decoded the admitted rows, so their slots
                # must be live before their chunk tokens are appended.
                self._finalize_admission(finalize["reqs"], finalize["slots"],
                                         finalize["keep_rows"], arr[:, -1])
                self._process_emitted(arr[:, :-2], arr[:, -2].astype(bool))
                return
            self._process_emitted(arr[:, :-1], arr[:, -1].astype(bool))
            if finalize is not None:
                # The scan-sliced admission's last round: sample the first tokens
                # from the captured hidden states, then the rows go live.
                first = self._run("mixed_first")
                self._finalize_admission(finalize["reqs"], finalize["slots"],
                                         finalize["keep_rows"], first.cpu().numpy(),
                                         device_synced=False)

    def _op_mixed_first(self) -> torch.Tensor:
        """The first tokens (A,) of the scan-sliced admission whose last
        round ran."""
        st, self._finalizing = self._finalizing, None
        return _sample_admission_first(self.model, st["last_hidden"], st["temp"],
                                       st["topp"], self.generator)

    def _finish(self, slot: int, reason: str) -> None:
        req = self.slots[slot]
        if req is not None:
            req.finish_reason = reason
            req.finished_s = time.perf_counter()
            self.total_output_tokens += len(req.output_tokens)
            self.metrics.record_request(req)
            req.stream_queue.put(None)
        self.slots[slot] = None
        self.live_host[slot] = False
        self._finished_total += 1

    def _active_device(self) -> torch.Tensor:
        key = self.live_host.tobytes()
        if self._active_key != key:
            self._active_dev.copy_(torch.from_numpy(self.live_host))
            self._active_key = key
        return self._active_dev

    def _count_round(self, counts: Dict[str, int], kind: str) -> None:
        with self._round_log_lock:
            counts[kind] += 1

    def _log_capture(self, kind: str, key: tuple, graph, seconds: float) -> None:
        """Record a capture: its kind, key, seconds (the warm-up step
        included), the pool bytes it added and the decoder glue's call sites
        the captured step ran by path, fused or eager (each None from a
        stand-in that captured nothing)."""
        with self._round_log_lock:
            self.graph_captures.append(dict(kind=kind, key=list(key), seconds=seconds,
                                            pool_bytes=getattr(graph, "pool_bytes", None),
                                            glue_calls=getattr(graph, "glue_calls", None)))

    def _decode_round(self, kind: str) -> torch.Tensor:
        """A decode chunk of every live slot over the decode state, the
        packed (B, chunk + 1) result; ``kind`` is the round's ("decode", or
        "block" for a fused block round's chunk).  On the card it replays
        the graph of one decode step, captured in the first chunk."""
        args = (self.model, self.decode_chunk, self.caches, self.tokens, self.cur_lens,
                self._active_device(), self.temperature, self.top_p, self._eos_dev,
                self.budget, self.generator)
        if self.eager_decode_reason is not None:
            self._count_round(self.eager_rounds, kind)
            return _decode_all_slots(*args)
        if self._decode_graph is None:
            start = time.perf_counter()
            self._decode_graph = _DecodeStepGraph(*args)
            self._log_capture("decode", (self.max_batch_size, self.decode_chunk),
                              self._decode_graph, time.perf_counter() - start)
        self._count_round(self.graph_rounds, kind)
        return self._decode_graph.round()

    def _dispatch_decode(self):
        return ("decode", self._decode_round("decode"), None, 0, 0)

    def _dispatch_round(self):
        """Dispatch the next device round; None when there is none."""
        # Honour cancellations before spending device time.
        for slot, req in enumerate(self.slots):
            if req is not None and req.cancelled and self.live_host[slot]:
                self._finish(slot, "cancelled")
        if self._pending_mixed is None and not self.live_host.any():
            return None
        with self._span(self._round_spans, "dispatch_s"):
            return self._run("round", self.live_host.copy())

    def _op_round(self, live: np.ndarray):
        """The round the staged admission and the ``live`` slots call for."""
        self.live_host[:] = live  # a follower's mirror of the driver's
        if self._pending_mixed is not None:
            if self._pending_mixed["mode"] == "block":
                return self._dispatch_block()
            return self._dispatch_mixed()
        return self._dispatch_decode()

    def _process_emitted(self, emitted_host: np.ndarray, live_host: np.ndarray) -> None:
        for slot, req in enumerate(self.slots):
            if req is None or not self.live_host[slot]:
                continue
            eos = set(self.eos_token_ids) | set(req.params.stop_token_ids)
            toks = [int(t) for t in emitted_host[slot] if t >= 0]
            out = []
            finished = None
            for t in toks:
                if t in eos:
                    finished = "stop"
                    break
                out.append(t)
            if out:
                req.output_tokens.extend(out)
                req.stream_queue.put(out)
                self.streamed_tokens += len(out)
            if finished is None and not live_host[slot]:
                finished = "length"
            if finished:
                self._finish(slot, finished)

    def _loop(self) -> None:
        """Engine loop: dispatch a round, fetch its result, then stage the
        next admission (complete -> admit -> dispatch), so a slot freed in
        round N decodes its replacement in round N + 1.  A bounded grace
        (admit_grace_s) after a round that freed slots lets replacement
        submissions join the same wave.  A failed step fails every
        in-flight request and the loop keeps serving; under tensor
        parallelism it also ends the loop (``loop_error``), since the ranks
        may have parted mid-step.  A loop that ends normally tells the
        followers to stop."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            # The stream is empty: the device clock's first anchor.
            torch.cuda.synchronize(self.device)
            self._clock = DeviceClock()
        with torch.inference_mode():
            while not self._stop.is_set():
                try:
                    t0 = time.perf_counter()
                    n_live = int(self.live_host.sum())
                    tok0 = self.streamed_tokens
                    self._round_spans = {}
                    handle = self._dispatch_round()
                    if handle is None:
                        if not self.waiting.empty():
                            # Idle device: monolithic admission runs here.
                            self._admit()
                        elif self._pending_mixed is None and not self.live_host.any():
                            with self._span(self._carry, "idle_s"):
                                self._wake.wait(timeout=0.05)
                            self._wake.clear()
                            self._anchor()  # nothing runs on an idle engine's stream
                            if (self.mesh is not None
                                    and time.perf_counter() - self._last_plan_s > HEARTBEAT_S):
                                self._run("idle")
                        continue
                    fin0 = self._finished_total
                    self._complete_round(handle)
                    device = self._device_fields()
                    t_done = time.perf_counter()
                    if self._pending_mixed is None:
                        if self._finished_total > fin0:
                            with self._span(self._carry, "grace_s"):
                                want = min(self._finished_total - fin0, self._a_bucket)
                                grace = time.perf_counter() + self.admit_grace_s
                                while (self.waiting.qsize() < want
                                       and time.perf_counter() < grace):
                                    time.sleep(0.0005)
                        if not self.waiting.empty():
                            self._admit()
                    # Fused block rounds decode their admitted rows in the
                    # same round, so those count as live.
                    rows_live = n_live + (handle[3] if handle[0] == "block" else 0)
                    t_end = time.perf_counter()
                    spans = {f: self._round_spans.get(f, 0.0) + self._carry.get(f, 0.0)
                             for f in SPANS}
                    self._carry = {}
                    self._log_round(kind=handle[0], admit_s=t_end - t_done,
                                    round_s=t_done - t0, live=rows_live, a=handle[3],
                                    rows=handle[4], emitted=self.streamed_tokens - tok0,
                                    gap_s=t0 - self._last_round_end, **spans, **device)
                    self._last_round_end = t_end
                except Exception as err:  # the engine survives a bad step
                    traceback.print_exc()
                    self._carry = {}
                    self._dev_pending, self._dev_round = ([], []), None
                    self._pending_mixed = None
                    for slot, req in enumerate(self.slots):
                        if req is not None:
                            self._fail(req, f"engine step failed: {err}")
                            self.slots[slot] = None
                    self.live_host[:] = False
                    if self.mesh is not None:
                        # The ranks may have parted mid-step and cannot be
                        # brought back into step: the loop ends.
                        self.loop_error = f"{type(err).__name__}: {err}"
                        while not self.waiting.empty():
                            self._fail(self.waiting.get_nowait(), "engine step failed: "
                                       f"{self.loop_error}")
                        return
            if self.mesh is not None:
                self._stop_followers()

    # -- metrics -----------------------------------------------------------

    def round_snapshot(self) -> list:
        """Thread-safe copy of the round-anatomy ring buffer."""
        with self._round_log_lock:
            return list(self.round_log)

    def stats(self) -> Dict[str, Any]:
        """The engine's state and its span record for an operator
        (``/metrics``): per round kind the rounds, their mean host
        milliseconds, tokens and, on the card, device seconds; the host
        seconds of each span name (``span_s``); the device seconds between
        rounds that no device work covers (``device_gap_s``, None off the
        card); the queue wait's p50 and p99; the admitted requests by route;
        the spans of ``slow_event_s`` or more (``slow_events``); the decoder
        glue's call sites by path since the process started (``glue_calls``,
        fused or eager; a graph's replays count nothing, its capture once);
        for a decoder with routed experts, the rows routed to each expert of
        each layer since it was built (``expert_tokens``, a device counter
        read here); and the request metrics."""
        out: Dict[str, Any] = {
            "active_slots": int(self.live_host.sum()),
            "max_batch_size": self.max_batch_size,
            "waiting": self.waiting.qsize(),
            "total_requests": self.total_requests,
            "total_output_tokens": self.total_output_tokens,
            "decode_graph": self.eager_decode_reason is None,
            "eager_decode_reason": self.eager_decode_reason,
            "loop_error": self.loop_error,
        }
        with self._round_log_lock:
            out["graph_rounds"] = dict(self.graph_rounds)
            out["eager_rounds"] = dict(self.eager_rounds)
            out["graph_captures"] = [dict(c) for c in self.graph_captures]
            waits = sorted(self._queue_waits)
            out["admissions"] = dict(self._routes)
        out["glue_calls"] = fused_glue.counts()
        experts = getattr(self.model.llm, "expert_tokens", None)
        if experts is not None:
            out["expert_tokens"] = experts.tolist()
        rounds = self.round_snapshot()
        agg: Dict[str, list] = collections.defaultdict(lambda: [0, 0.0, 0, 0.0, None])
        spans = dict.fromkeys(SPANS.values(), 0.0)
        slow = 0
        for r in rounds:
            g = agg[r["kind"]]
            g[0] += 1
            g[1] += r["round_s"]
            g[2] += r["emitted"]
            g[3] += r["gap_s"]
            if r["dev_start"] is not None:
                g[4] = (g[4] or 0.0) + r["dev_end"] - r["dev_start"]
            for field, name in SPANS.items():
                spans[name] += r[field]
                slow += r[field] >= self.slow_event_s
        for kind, (n, rnd, emitted, _, device) in agg.items():
            out[f"rounds_{kind}"] = n
            out[f"round_{kind}_mean_ms"] = round(rnd / n * 1e3, 1)
            out[f"round_{kind}_tokens"] = emitted
            if device is not None:
                out[f"round_{kind}_device_s"] = device
        out["round_gap_total_s"] = round(sum(g[3] for g in agg.values()), 2)
        out["span_s"] = spans
        out["device_gap_s"] = device_gap_s(rounds)
        for p in (50, 99):
            out[f"queue_wait_p{p}_ms"] = (
                waits[min(len(waits) * p // 100, len(waits) - 1)] * 1e3 if waits else None)
        out["slow_events"] = slow
        out.update(self.metrics.summary())
        return out
