"""Batch inference engine: prefill, monolithic or in chunks, then decode in
chunks.

Counterpart of ``chatts_tpu/runtime/engine.py::InferenceEngine`` (its
per-step-scatter decode, ``decode_recent_kv=False``).  ``generate`` takes a
``ProcessedBatch`` from the port's ``processor/processor.py`` and:

1. allocates a head-major KV cache of ``prompt + max_new_tokens`` rounded up
   to 256 positions (chunked: at least the padded prompt, rounded up to the
   chunk's ``kv_step`` first, as the reference does);
2. prefills the whole prompt block (TS encoder, patch merge, decoder) and
   samples the first token from ``hidden[seq_lens - 1]``; with
   ``prefill_act_int8`` the prefill's projections quantize their input rows
   to int8 (``Dense(act_int8=True)``), and decode stays in x's type.  With
   ``prefill_chunk`` a prompt longer than the chunk is prefilled chunk by
   chunk instead: the embeddings once, then each chunk written at its
   absolute slots and attending the cache prefix ``[:kv_limit]``, where
   ``kv_limit`` steps by ``kv_step = max(2 * chunk, 2048)``; as in the
   reference, a chunked prefill takes no ``act_int8``;
3. decodes ``decode_chunk`` steps at a time, the port of the reference's
   ``_decode_chunk``.  Finished rows emit ``pad_id`` and keep their length;
   EOS and the done mask are computed on the device, each step writes its
   tokens into the next column of a (B, decode_chunk) buffer, and the host
   syncs once per chunk.  On the card one decode step is a CUDA graph
   (``runtime/graphs.py``) replayed once a step.  It is keyed by (B,
   ``cache_len``, the cache's type, ``decode_chunk``, the sampling mode of
   ``gen_cfg`` and its EOS ids) and holds the cache it was captured over, so
   that calls with the same key reuse both and only a new key captures
   again.  It draws from a generator of its own, set from the caller's
   before a chunk and copied back after, so that the caller's generator
   advances as the eager steps would advance it.  Off the card, or on a
   gloo mesh (``eager_decode_reason``), the same step runs eagerly.

On a model placed on a mesh (``parallel/sharding.py``) every rank runs
``generate`` on the same ``ProcessedBatch``: each dp group takes its rows
(``local_batch``), tp rank 0 samples and its ids are broadcast over the tp
group, so ranks never diverge on near-tied logits, and the dp groups' token
ids are gathered at the end.

TTFT and TPOT are host-clock times around work that ends in a device sync.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from chatts_tpu_torch.core.config import ChatTSConfig, GenerationConfig
from chatts_tpu_torch.processor.processor import ProcessedBatch
from chatts_tpu_torch.models.chatts import ChatTSModel, maybe_fuse
from chatts_tpu_torch.models.convert import from_jax_params
from chatts_tpu_torch.ops import fused_glue
from chatts_tpu_torch.parallel.mesh import all_gather_dp, broadcast_from_driver
from chatts_tpu_torch.parallel.sharding import infer_mesh, local_batch
from chatts_tpu_torch.runtime import graphs, kv_cache, sampling

CACHE_BUCKET = 256


@dataclasses.dataclass
class GenerateResult:
    token_ids: List[List[int]]  # generated ids per row (EOS trimmed)
    prompt_lens: List[int]
    ttft_s: float  # time to first token (prefill + 1 sample)
    tpot_s: float  # mean time per decode step after the first token
    total_s: float

    @property
    def total_new_tokens(self) -> int:
        return sum(len(t) for t in self.token_ids)


def kv_step(prefill_chunk: int) -> int:
    """The step of a chunked prefill's ``kv_limit`` ladder and cache length."""
    return max(2 * prefill_chunk, 2048)


def default_cache_len(prompt_len: int, max_new_tokens: int,
                      prefill_chunk: Optional[int] = None) -> int:
    """Prompt + new tokens, rounded up to a multiple of 256.  A chunked
    prefill (``prefill_chunk`` set and below the prompt) writes the whole
    padded prompt, and its capacity is first rounded up to ``kv_step``."""
    n = prompt_len + max_new_tokens
    if prefill_chunk is not None and prompt_len > prefill_chunk:
        step = kv_step(prefill_chunk)
        n = max(n, -(-prompt_len // prefill_chunk) * prefill_chunk)
        n = -(-n // step) * step
    return -(-n // CACHE_BUCKET) * CACHE_BUCKET


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sampling_key(gen_cfg: GenerationConfig) -> tuple:
    """What of ``gen_cfg`` a captured decode step holds: greedy, or the
    temperature, top-k and top-p it samples with; then the EOS ids."""
    if gen_cfg.greedy or gen_cfg.temperature <= 0.0:
        mode: tuple = ("greedy",)
    else:
        mode = ("sample", gen_cfg.temperature, gen_cfg.top_k, gen_cfg.top_p)
    return mode + (tuple(gen_cfg.eos_token_ids),)


class _DecodeState:
    """A ``generate`` call's decode state at addresses that never move: the
    cache, the last tokens, the lengths, the done mask and the chunk's
    (B, decode_chunk) token buffer, with the column the next step writes."""

    def __init__(self, key: tuple, caches, b: int, chunk: int, gen_cfg: GenerationConfig,
                 device: torch.device):
        self.key, self.caches = key, caches
        self.tokens = torch.zeros((b,), dtype=torch.int32, device=device)
        self.cur_lens = torch.zeros((b,), dtype=torch.int32, device=device)
        self.done = torch.zeros((b,), dtype=torch.bool, device=device)
        self.eos_ids = torch.tensor(list(gen_cfg.eos_token_ids) or [-1], dtype=torch.int32,
                                    device=device)
        self.emitted = torch.zeros((b, chunk), dtype=torch.int32, device=device)
        self.column = torch.zeros((b, 1), dtype=torch.int64, device=device)


def _next_tokens(engine: "InferenceEngine", state: _DecodeState, generator, gen_cfg):
    """One decode step of every row: (the next tokens, pad_id where a row
    was done; the new done mask).  Writes each row's K/V at its length."""
    next_tok = engine._decode_step(state.caches, state.tokens, state.cur_lens, generator,
                                   gen_cfg)
    next_tok = torch.where(state.done, engine.pad_id, next_tok).to(torch.int32)
    new_done = state.done | (next_tok[:, None] == state.eos_ids[None, :]).any(dim=1)
    return next_tok, new_done


def _decode_step_in_place(engine: "InferenceEngine", state: _DecodeState, generator,
                          gen_cfg) -> None:
    """One decode step with the state updated in place and its tokens
    written into the next column of ``state.emitted``."""
    next_tok, new_done = _next_tokens(engine, state, generator, gen_cfg)
    state.cur_lens += (~state.done).to(torch.int32)
    state.done.copy_(new_done)
    state.tokens.copy_(next_tok)
    state.emitted.scatter_(1, state.column, next_tok[:, None])
    state.column += 1


def _decode_chunk(engine: "InferenceEngine", state: _DecodeState, steps: int, generator,
                  gen_cfg) -> None:
    """``steps`` decode steps run eagerly (off the card, on a gloo mesh)."""
    state.column.zero_()
    for _ in range(steps):
        _decode_step_in_place(engine, state, generator, gen_cfg)


class _BatchDecodeGraph:
    """One decode step of ``state`` captured in a CUDA graph; ``chunk``
    replays it once a step.  The graph draws from a generator of its own:
    a chunk sets it from the caller's first and copies it back after, so
    the caller's generator advances as the eager steps advance it."""

    def __init__(self, engine: "InferenceEngine", state: _DecodeState, gen_cfg):
        self.state = state
        self.generator = torch.Generator(device=engine.device)
        # The warm-up step updates no state and draws from a generator of
        # its own; its K/V writes are the ones the first replay makes.
        self.glue_calls: Dict[str, int] = {}
        self.graph, self.pool_bytes = graphs.capture(
            lambda: _next_tokens(engine, state, torch.Generator(device=engine.device), gen_cfg),
            fused_glue.counting(
                lambda: _decode_step_in_place(engine, state, self.generator, gen_cfg),
                self.glue_calls),
            self.generator)

    def chunk(self, steps: int, generator: torch.Generator) -> None:
        self.generator.set_state(generator.get_state())
        self.state.column.zero_()
        for _ in range(steps):
            self.graph.replay()
        generator.set_state(self.generator.get_state())


class InferenceEngine:
    """Owns the model on ``device`` (the card unless the caller asks for
    the CPU) and the generation loop."""

    def __init__(
        self,
        params_or_model: Union[ChatTSModel, Mapping[str, Any]],
        cfg: ChatTSConfig,
        *,
        device="cuda",
        cache_dtype=torch.bfloat16,
        decode_chunk: int = 64,
        pad_id: int = 0,
        fuse: bool = True,
        prefill_act_int8: bool = False,
        prefill_chunk: Optional[int] = None,
    ):
        self.device = torch.device(device)
        if isinstance(params_or_model, ChatTSModel):
            model = params_or_model.to(self.device)
        else:
            model = from_jax_params(params_or_model, cfg, self.device)
        if fuse:
            model = maybe_fuse(model)
        self.model = model.eval()
        self.mesh = infer_mesh(model)
        self.cfg = cfg
        self.cache_dtype = cache_dtype
        self.decode_chunk = decode_chunk
        self.pad_id = pad_id
        self.prefill_act_int8 = prefill_act_int8
        # Prompts longer than this prefill in chunks of this many tokens.
        self.prefill_chunk = prefill_chunk
        # The decode step's graph and the state and cache it was captured
        # over (``_BatchDecodeGraph``), kept for the next call with its key.
        self._decode_graph: Optional[_BatchDecodeGraph] = None
        # Why decode chunks run eagerly, or None when they replay the graph.
        self.eager_decode_reason: Optional[str] = None
        if self.device.type != "cuda":
            self.eager_decode_reason = "no CUDA graphs off the card"
        elif self.mesh is not None and self.mesh.backend != "nccl":
            self.eager_decode_reason = (f"{self.mesh.backend} collectives cannot be captured "
                                        f"in a CUDA graph")
            print(f"[InferenceEngine] decode chunks run eagerly: {self.eager_decode_reason}",
                  file=sys.stderr)
        # Decode chunks run by form ("graph", "eager"), and each capture's
        # key, seconds and pool bytes.
        self.decode_chunks = {"graph": 0, "eager": 0}
        self.graph_captures: List[dict] = []

    def _tensor(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    def _sample(self, logits, generator, gen_cfg) -> torch.Tensor:
        """Next ids (B,) int32; under a mesh tp rank 0's, broadcast."""
        return broadcast_from_driver(self.mesh, sampling.sample(logits, generator, gen_cfg))

    def _decode_step(self, caches, tokens, cur_lens, generator, gen_cfg):
        llm = self.model.llm
        positions = cur_lens[:, None]
        hidden, _ = llm(
            llm.embed(tokens[:, None]), positions,
            kv_caches=caches, write_pos=positions, kv_lengths=cur_lens + 1,
        )
        logits = llm.compute_logits(hidden)[:, 0]
        return self._sample(logits, generator, gen_cfg)

    def _chunked_prefill(self, batch: ProcessedBatch, seq_lens: torch.Tensor,
                         caches, cache_len: int) -> torch.Tensor:
        """The port of the reference's ``_chunked_prefill``: the merged
        embeddings once over the whole prompt, zero-padded to a whole number
        of chunks (positions padded with each row's last), then the decoder
        chunk by chunk, each chunk written at absolute slots [o, o + c) and
        attending the cache prefix [:kv_limit].  Returns the hidden states
        (B, t_pad, hidden)."""
        dev = self.device
        b, t = batch.input_ids.shape
        c = self.prefill_chunk
        t_pad = -(-t // c) * c
        embeds = self.model.input_embeddings(
            self._tensor(batch.input_ids, torch.int64),
            self._tensor(batch.ts_values, torch.float32),
            self._tensor(batch.ts_mask, torch.float32),
            self._tensor(batch.scatter_seq, torch.int64),
            self._tensor(batch.scatter_tok, torch.int64),
        )
        positions = self._tensor(batch.positions, torch.int32)
        if t_pad > t:
            embeds = F.pad(embeds, (0, 0, 0, t_pad - t))
            positions = torch.cat([positions, positions[:, -1:].expand(b, t_pad - t)], dim=1)
        kv_positions = torch.arange(cache_len, dtype=torch.int32, device=dev)[None].repeat(b, 1)
        kv_valid = kv_positions < seq_lens[:, None]
        step = kv_step(c)
        hiddens = []
        for o in range(0, t_pad, c):
            hidden, _ = self.model.llm(
                embeds[:, o:o + c], positions[:, o:o + c], kv_caches=caches,
                write_pos=kv_positions[:, o:o + c], kv_valid=kv_valid,
                kv_positions=kv_positions,
                kv_limit=min(cache_len, -(-(o + c) // step) * step),
            )
            hiddens.append(hidden)
        return torch.cat(hiddens, dim=1)

    @torch.inference_mode()
    def generate(
        self,
        batch: ProcessedBatch,
        gen_cfg: Optional[GenerationConfig] = None,
        *,
        generator: Optional[torch.Generator] = None,
        cache_len: Optional[int] = None,
    ) -> GenerateResult:
        gen_cfg = gen_cfg or GenerationConfig()
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        dev = self.device
        prompt_lens = [int(x) for x in batch.seq_lens]
        batch = local_batch(batch, self.mesh)
        b, t = batch.input_ids.shape
        chunked = self.prefill_chunk is not None and t > self.prefill_chunk
        if cache_len is None:
            cache_len = default_cache_len(t, gen_cfg.max_new_tokens, self.prefill_chunk)
        # Prefill writes t positions (a chunked one the padded prompt); the
        # last decode step writes at seq_len + max_new_tokens - 2.  An index
        # past the cache would fault on the card, where JAX would drop the
        # write.
        written = -(-t // self.prefill_chunk) * self.prefill_chunk if chunked else t
        need = max(written, int(np.max(batch.seq_lens)) + gen_cfg.max_new_tokens - 1)
        if cache_len < need:
            raise ValueError(f"cache_len {cache_len} < {need} positions this batch needs")

        start = time.perf_counter()
        seq_lens = self._tensor(batch.seq_lens, torch.int32)
        key = (b, cache_len, self.cache_dtype, self.decode_chunk, _sampling_key(gen_cfg))
        graph = self._decode_graph if self.eager_decode_reason is None else None
        if graph is not None and graph.state.key == key:
            state = graph.state
            kv_cache.reset(state.caches)
        else:
            self._decode_graph = graph = None  # its cache is freed before the new one
            state = _DecodeState(
                key, kv_cache.allocate(self.cfg.llm, b, cache_len, self.cache_dtype, dev,
                                       kv_heads=self.model.llm.kv_heads),
                b, self.decode_chunk, gen_cfg, dev)
        caches = state.caches
        if chunked:
            hidden = self._chunked_prefill(batch, seq_lens, caches, cache_len)
        else:
            kv_positions = torch.arange(cache_len, dtype=torch.int32, device=dev)[None].repeat(b, 1)
            hidden, caches = self.model(
                self._tensor(batch.input_ids, torch.int64),
                self._tensor(batch.positions, torch.int32),
                ts_values=self._tensor(batch.ts_values, torch.float32),
                ts_mask=self._tensor(batch.ts_mask, torch.float32),
                scatter_seq=self._tensor(batch.scatter_seq, torch.int64),
                scatter_tok=self._tensor(batch.scatter_tok, torch.int64),
                kv_caches=caches,
                kv_valid=kv_positions < seq_lens[:, None],
                kv_positions=kv_positions,
                act_int8=self.prefill_act_int8,
            )
        last_idx = (seq_lens.long() - 1)[:, None, None].expand(b, 1, hidden.shape[-1])
        logits = self.model.compute_logits(hidden.gather(1, last_idx))[:, 0]
        tokens = self._sample(logits, generator, gen_cfg)
        _sync(dev)
        first_tokens = tokens.cpu().numpy()
        ttft = time.perf_counter() - start

        eos = set(gen_cfg.eos_token_ids)
        done_host = np.array([int(tok) in eos for tok in first_tokens])
        state.tokens.copy_(tokens)
        state.cur_lens.copy_(seq_lens)
        state.done.copy_(torch.as_tensor(done_host, device=dev))

        chunk = max(1, min(self.decode_chunk, gen_cfg.max_new_tokens - 1))
        decode_start = time.perf_counter()
        steps = 0
        remaining = gen_cfg.max_new_tokens - 1
        collected: List[np.ndarray] = []
        while remaining > 0 and not done_host.all():
            step = min(chunk, remaining)
            if self.eager_decode_reason is not None:
                _decode_chunk(self, state, step, generator, gen_cfg)
                self.decode_chunks["eager"] += 1
            else:
                if graph is None:
                    capture_start = time.perf_counter()
                    graph = self._decode_graph = _BatchDecodeGraph(self, state, gen_cfg)
                    # pool_bytes is None from a stand-in that captured nothing.
                    self.graph_captures.append(dict(
                        kind="decode", key=repr(key),
                        seconds=time.perf_counter() - capture_start,
                        pool_bytes=getattr(graph, "pool_bytes", None),
                        glue_calls=getattr(graph, "glue_calls", None)))
                graph.chunk(step, generator)
                self.decode_chunks["graph"] += 1
            packed = torch.cat([state.emitted[:, :step], state.done[:, None].to(torch.int32)],
                               dim=1).cpu().numpy()  # one sync
            collected.append(packed[:, :-1])
            done_host = packed[:, -1].astype(bool)
            remaining -= step
            steps += step
        _sync(dev)
        total = time.perf_counter() - start
        tpot = (time.perf_counter() - decode_start) / max(steps, 1)

        all_toks = (np.concatenate(collected, axis=1) if collected
                    else np.zeros((b, 0), np.int32))
        outputs: List[List[int]] = []
        for i in range(b):
            first = int(first_tokens[i])
            row: List[int] = []
            if first not in eos:
                row.append(first)
                for tok in all_toks[i]:
                    if int(tok) in eos:
                        break
                    row.append(int(tok))
            outputs.append(row)
        outputs = [row for part in all_gather_dp(self.mesh, outputs) for row in part]
        return GenerateResult(
            token_ids=outputs,
            prompt_lens=prompt_lens,
            ttft_s=ttft,
            tpot_s=tpot,
            total_s=total,
        )
