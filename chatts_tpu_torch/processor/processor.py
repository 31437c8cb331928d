"""Host-side ChatTS processor: text + raw series -> static-shape device batch.

The port's own copy of ``chatts_tpu/processor/processor.py``: the same
``ProcessedBatch`` from the same prompts, with the port's config, encoding
and native packer.

Native implementation of the HF checkpoint's remote-code processor contract
(reference: README.md:81-104, chatts/utils/inference_tsmllm_deepspeed.py:89-92)
and of the vLLM placeholder-expansion plumbing
(reference: chatts/vllm/chatts_vllm.py:369-444):

1. Each ``<ts><ts/>`` hole in the prompt is prefixed by the sp-encoding echo
   text ("[Value Offset: ...|Value Scaling: ...]") so raw values stay
   answerable.
2. The hole expands to ``ceil(L / patch_size)`` copies of the placeholder
   token id ``ts_token_start_index`` followed by the ``<ts/>`` end-token id
   (reference: chatts_vllm.py:402-415 — the processor-provided token run the
   vLLM patch would otherwise pad out).
3. Everything ragged is bucketed to static shapes on host: series length,
   series count, and token length each round up to a small set of buckets so
   the device sees few distinct shapes, never one per request.
4. The (series, patch) -> (sequence, token) scatter map for the embedding
   merge is computed here, so the device graph needs no dynamic indexing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from chatts_tpu_torch.core import encoding
from chatts_tpu_torch.core.config import ChatTSConfig

DEFAULT_LEN_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)
TOKEN_BUCKET_MULTIPLE = 128


def bucket_series_len(n: int, buckets: Sequence[int] = DEFAULT_LEN_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return -(-n // buckets[-1]) * buckets[-1]


def bucket_count(n: int) -> int:
    """Round a count up to the next power of two (min 1)."""
    b = 1
    while b < n:
        b *= 2
    return b


def bucket_tokens(n: int, multiple: int = TOKEN_BUCKET_MULTIPLE) -> int:
    """Progressive token buckets: fine (128) steps where prefill is cheap,
    coarser steps for long prompts so the number of distinct compiled prefill
    shapes stays bounded (~24 shapes to 6k tokens instead of 48) at <=~16%
    pad overhead.  Every bucket stays a multiple of 128 (flash-kernel block
    divisibility)."""
    if n <= 1536:
        step = multiple
    elif n <= 3072:
        step = 2 * multiple
    elif n <= 6144:
        step = 4 * multiple
    else:
        step = 8 * multiple
    return max(multiple, -(-n // step) * step)


@dataclasses.dataclass
class ProcessedBatch:
    """A fully padded, static-shape batch ready for the device."""

    input_ids: np.ndarray  # (B, T) int32
    attention_mask: np.ndarray  # (B, T) int32, 1 = real token
    positions: np.ndarray  # (B, T) int32
    seq_lens: np.ndarray  # (B,) int32
    ts_values: np.ndarray  # (N, Lmax) float32
    ts_mask: np.ndarray  # (N, Lmax) float32
    scatter_seq: np.ndarray  # (N, Pmax) int32, OOB sentinel for padding
    scatter_tok: np.ndarray  # (N, Pmax) int32
    patch_cnt: np.ndarray  # (N,) int32
    encoded_prompts: List[str]  # prompts with encoding echoes inserted
    ts_metas: List[List[Dict[str, float]]]  # per-sample per-series sp meta

    @property
    def num_ts_tokens(self) -> int:
        return int(self.patch_cnt.sum())

    def to_model_kwargs(self) -> Dict[str, Any]:
        return {
            "input_ids": self.input_ids,
            "ts_values": self.ts_values,
            "ts_mask": self.ts_mask,
            "scatter_seq": self.scatter_seq,
            "scatter_tok": self.scatter_tok,
        }


class ChatTSProcessor:
    """Tokenizer + TS-encoding front end.

    ``tokenizer`` must expose ``encode(text, add_special_tokens=False) ->
    list[int]`` (HF tokenizers qualify).  The ``<ts>``/``<ts/>`` token ids come
    from the model config, not from tokenizer lookup, matching the reference's
    ``config.ts_token_start_index`` contract (chatts_vllm.py:376).
    """

    def __init__(
        self,
        tokenizer,
        config: ChatTSConfig,
        encoding_method: str = "sp",
        pad_token_id: Optional[int] = None,
        series_count_floor: int = 1,
        series_len_floor: int = 0,
    ):
        self.tokenizer = tokenizer
        self.config = config
        self.encoding_method = encoding_method
        # Minimum series-count bucket.  Serving sets this to ~2x slots so
        # admission batches of varying size land in ONE compiled shape —
        # padded encoder rows are masked out and cost almost nothing, while
        # a fresh series bucket costs a multi-second jit compile mid-traffic.
        self.series_count_floor = max(1, int(series_count_floor))
        # Minimum series-length bucket, same motivation: open traffic with
        # mixed series lengths (the reference eval mix is 64-1024 points)
        # otherwise keys a fresh admission-embed compile per (count, len)
        # bucket combination; flooring the length collapses that axis.
        # Padded points are masked in the encoder (the sp valid channel).
        self.series_len_floor = max(0, int(series_len_floor))
        if pad_token_id is None:
            pad_token_id = getattr(tokenizer, "pad_token_id", None)
            if pad_token_id is None:
                pad_token_id = getattr(tokenizer, "eos_token_id", 0) or 0
        self.pad_token_id = int(pad_token_id)

    # -- single prompt -----------------------------------------------------

    def encode_prompt(self, text: str, timeseries: List[np.ndarray]):
        """Returns (token_ids, series_list, per-series patch counts,
        per-series placeholder start offsets, encoded text, metas)."""
        cfg = self.config
        parts = text.split(encoding.TS_PAIR)
        if len(parts) - 1 != len(timeseries):
            raise ValueError(
                f"prompt has {len(parts) - 1} {encoding.TS_PAIR} holes but "
                f"{len(timeseries)} series were given"
            )
        if len(timeseries) > cfg.max_timeseries_per_prompt:
            # reference limit: 50 series per prompt (chatts_vllm.py:220).
            raise ValueError(
                f"{len(timeseries)} series exceed the per-prompt limit of "
                f"{cfg.max_timeseries_per_prompt}"
            )
        ids: List[int] = list(
            self.tokenizer.encode(parts[0], add_special_tokens=False)
        )
        encoded_text = parts[0]
        patch_cnts: List[int] = []
        starts: List[int] = []
        metas: List[Dict[str, float]] = []
        series_arrays: List[np.ndarray] = []
        for i, ts in enumerate(timeseries):
            ts = np.asarray(ts, dtype=np.float64).reshape(-1)
            if len(ts) > cfg.ts.max_sequence_length:
                raise ValueError(
                    f"series of length {len(ts)} exceeds max_sequence_length="
                    f"{cfg.ts.max_sequence_length}"
                )
            if self.encoding_method == "sp":
                enc, frag, meta = encoding.sp_encoding(ts)
                values = enc.reshape(-1, 2)[:, 0]
            else:
                enc, frag, meta = encoding.timeseries_encoding(
                    ts, self.encoding_method
                )
                values = np.asarray(enc).reshape(len(ts), -1)[:, 0]
            series_arrays.append(values.astype(np.float32))
            metas.append(meta)
            # Echo text before the hole, then the expanded placeholder run.
            echo = frag[: -len(encoding.TS_PAIR)]
            if echo:
                ids.extend(self.tokenizer.encode(echo, add_special_tokens=False))
            pc = encoding.num_patches(len(ts), cfg.ts.patch_size)
            starts.append(len(ids))
            ids.extend([cfg.ts_token_start_index] * pc)
            ids.append(cfg.ts_end_token_index)
            patch_cnts.append(pc)
            encoded_text += frag + parts[i + 1]
            tail = self.tokenizer.encode(parts[i + 1], add_special_tokens=False)
            ids.extend(tail)
        return ids, series_arrays, patch_cnts, starts, encoded_text, metas

    def count_tokens(self, text: str, timeseries: Sequence[np.ndarray]) -> int:
        """Exact prompt token count (text + echo + expanded placeholders)
        without building any padded arrays — used by the scheduler's
        length-classed admission to group similar-length prompts into one
        wave (padded admission rows COMPUTE, so a wave pads every row to
        its longest member's bucket)."""
        ids, *_ = self.encode_prompt(
            text, [np.asarray(t) for t in timeseries])
        return len(ids)

    # -- batch -------------------------------------------------------------

    def __call__(
        self,
        text: Sequence[str],
        timeseries: Optional[Sequence[np.ndarray]] = None,
        *,
        pad_to_bucket: bool = True,
        pad_tokens_to: Optional[int] = None,
        use_native: Optional[bool] = None,
        padding: bool = True,  # HF-processor signature compat (README.md:98)
        return_tensors: Optional[str] = None,  # accepted and ignored (numpy)
        vllm_flag: bool = False,  # reference kwarg compat (chatts_vllm.py:333)
    ) -> ProcessedBatch:
        """Process a batch.

        ``timeseries`` is the flat list of series across the whole batch in
        prompt order, matching the reference processor's call convention
        (reference: inference_tsmllm_deepspeed.py:76-89).

        For sp encoding the host hot path (scale + pad + patchify + scatter
        map) runs through the native C++ packer when built
        (csrc/host_pack.cpp), with a numpy fallback.
        """
        cfg = self.config
        timeseries = list(timeseries or [])
        per_sample: List[tuple] = []
        cursor = 0
        for t in text:
            holes = t.count(encoding.TS_PAIR)
            sample_ts = timeseries[cursor : cursor + holes]
            cursor += holes
            per_sample.append(self.encode_prompt(t, sample_ts))
        if cursor != len(timeseries):
            raise ValueError(
                f"{len(timeseries)} series given but prompts consume {cursor}"
            )

        b = len(text)
        max_tok = max(len(s[0]) for s in per_sample)
        t_pad = bucket_tokens(max_tok) if pad_to_bucket else max_tok
        if pad_tokens_to is not None:
            # Caller-pinned token width (the scheduler's pad-to-class mode:
            # one compiled admission shape per length class instead of one
            # per fine bucket).  Must cover the longest prompt in the batch.
            if pad_tokens_to < max_tok:
                raise ValueError(
                    f"pad_tokens_to={pad_tokens_to} < longest prompt "
                    f"({max_tok} tokens)")
            t_pad = pad_tokens_to

        all_series = [ts for s in per_sample for ts in s[1]]
        n = len(all_series)
        n_pad = (
            max(bucket_count(n), self.series_count_floor)
            if (pad_to_bucket and n) else max(n, 1)
        )
        max_len = max((len(ts) for ts in all_series), default=cfg.ts.patch_size)
        l_pad = (
            max(bucket_series_len(max_len), self.series_len_floor)
            if pad_to_bucket
            else -(-max_len // cfg.ts.patch_size) * cfg.ts.patch_size
        )
        l_pad = -(-l_pad // cfg.ts.patch_size) * cfg.ts.patch_size
        p_max = l_pad // cfg.ts.patch_size

        input_ids = np.full((b, t_pad), self.pad_token_id, np.int32)
        attention_mask = np.zeros((b, t_pad), np.int32)
        seq_lens = np.zeros((b,), np.int32)
        encoded_prompts: List[str] = []
        ts_metas: List[List[Dict[str, float]]] = []
        flat_pcs: List[int] = []
        flat_seq: List[int] = []
        flat_start: List[int] = []
        for bi, (ids, series_arrays, pcs, starts, enc_text, metas) in enumerate(
            per_sample
        ):
            ln = len(ids)
            if ln > t_pad:
                raise ValueError(f"prompt of {ln} tokens exceeds pad length {t_pad}")
            input_ids[bi, :ln] = ids
            attention_mask[bi, :ln] = 1
            seq_lens[bi] = ln
            encoded_prompts.append(enc_text)
            ts_metas.append(metas)
            flat_pcs.extend(pcs)
            flat_seq.extend([bi] * len(pcs))
            flat_start.extend(starts)

        # Series arrays + scatter map: native fused pass when available.
        if use_native is None:
            use_native = True
        native_done = False
        if use_native and n:
            from chatts_tpu_torch.utils import native

            smap = native.build_scatter_map(
                np.asarray(flat_pcs, np.int32),
                np.asarray(flat_seq, np.int32),
                np.asarray(flat_start, np.int32),
                n_pad, p_max, b, t_pad,
            )
            if smap is not None:
                scatter_seq, scatter_tok = smap
                native_done = True
        if not native_done:
            scatter_seq = np.full((n_pad, p_max), b, np.int32)
            scatter_tok = np.full((n_pad, p_max), t_pad, np.int32)
            for i, (pc, bi, start) in enumerate(zip(flat_pcs, flat_seq, flat_start)):
                scatter_seq[i, :pc] = bi
                scatter_tok[i, :pc] = start + np.arange(pc)

        ts_values = np.zeros((n_pad, l_pad), np.float32)
        ts_mask = np.zeros((n_pad, l_pad), np.float32)
        patch_cnt = np.zeros((n_pad,), np.int32)
        for i, values in enumerate(all_series):
            ts_values[i, : len(values)] = values
            ts_mask[i, : len(values)] = 1.0
            patch_cnt[i] = flat_pcs[i]

        positions = np.tile(np.arange(t_pad, dtype=np.int32), (b, 1))
        return ProcessedBatch(
            input_ids=input_ids,
            attention_mask=attention_mask,
            positions=positions,
            seq_lens=seq_lens,
            ts_values=ts_values,
            ts_mask=ts_mask,
            scatter_seq=scatter_seq,
            scatter_tok=scatter_tok,
            patch_cnt=patch_cnt,
            encoded_prompts=encoded_prompts,
            ts_metas=ts_metas,
        )
