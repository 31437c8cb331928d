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
3. decodes ``decode_chunk`` steps at a time.  Finished rows emit ``pad_id``
   and keep their length; EOS and the done mask are computed on the device,
   and the host syncs once per chunk.  The steps run as a Python loop (a CUDA
   graph of the step is later work).

On a model placed on a mesh (``parallel/sharding.py``) every rank runs
``generate`` on the same ``ProcessedBatch``: each dp group takes its rows
(``local_batch``), tp rank 0 samples and its ids are broadcast over the tp
group, so ranks never diverge on near-tied logits, and the dp groups' token
ids are gathered at the end.

TTFT and TPOT are host-clock times around work that ends in a device sync.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from chatts_tpu_torch.core.config import ChatTSConfig, GenerationConfig
from chatts_tpu_torch.processor.processor import ProcessedBatch
from chatts_tpu_torch.models.chatts import ChatTSModel, maybe_fuse
from chatts_tpu_torch.models.convert import from_jax_params
from chatts_tpu_torch.parallel.mesh import all_gather_dp, broadcast_from_driver
from chatts_tpu_torch.parallel.sharding import infer_mesh, local_batch
from chatts_tpu_torch.runtime import kv_cache, sampling

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
        caches = kv_cache.allocate(self.cfg.llm, b, cache_len, self.cache_dtype, dev,
                                   kv_heads=self.model.llm.kv_heads)
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
        eos_ids = torch.tensor(list(gen_cfg.eos_token_ids) or [-1], dtype=torch.int32, device=dev)
        done_host = np.array([int(tok) in eos for tok in first_tokens])
        done = torch.as_tensor(done_host, device=dev)
        cur_lens = seq_lens.clone()

        chunk = max(1, min(self.decode_chunk, gen_cfg.max_new_tokens - 1))
        decode_start = time.perf_counter()
        steps = 0
        remaining = gen_cfg.max_new_tokens - 1
        collected: List[np.ndarray] = []
        while remaining > 0 and not done_host.all():
            step = min(chunk, remaining)
            chunk_tokens = []
            for _ in range(step):
                next_tok = self._decode_step(caches, tokens, cur_lens, generator, gen_cfg)
                next_tok = torch.where(done, self.pad_id, next_tok).to(torch.int32)
                new_done = done | (next_tok[:, None] == eos_ids[None, :]).any(dim=1)
                cur_lens = cur_lens + (~done).to(cur_lens.dtype)
                done, tokens = new_done, next_tok
                chunk_tokens.append(next_tok)
            collected.append(torch.stack(chunk_tokens, dim=1).cpu().numpy())  # one sync
            done_host = done.cpu().numpy()
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
