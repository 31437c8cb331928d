"""Training data: jsonl QA datasets -> loss-masked batches.

The port of ``chatts_tpu/train/data.py`` on the port's own processor.  It
consumes the ``{input, output, timeseries}`` rows every datagen pipeline
emits, applies the Qwen chat template, tokenizes prompt and answer apart so
that the loss mask covers only answer tokens, and pads through the
processor's token buckets.  Batches are numpy arrays, the JAX package's to
the element; ``to_device`` makes them tensors.  Shuffling uses
``np.random.default_rng(seed)``, so both packages see the same batches in the
same order.
"""
from __future__ import annotations

import json
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from chatts_tpu_torch.processor.processor import ChatTSProcessor, bucket_tokens

CHAT_TEMPLATE = (
    "<|im_start|>system\nYou are a helpful assistant.<|im_end|>"
    "<|im_start|>user\n{prompt}<|im_end|><|im_start|>assistant\n"
)


def load_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def build_sft_batch(
    processor: ChatTSProcessor,
    rows: Sequence[dict],
    max_answer_tokens: int = 512,
    eos_token_id: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """One training batch from dataset rows.

    Sequences are [chat-templated prompt (with TS placeholder expansion)] +
    [answer tokens (+EOS)]; targets are next-token shifted; loss_mask is 1
    only over answer positions."""
    prompts = [CHAT_TEMPLATE.format(prompt=row["input"]) for row in rows]
    flat_series: List[np.ndarray] = []
    for row in rows:
        for ts in row.get("timeseries") or []:
            arr = np.asarray(ts, dtype=np.float64)
            if arr.ndim > 1:  # (L, 1) or sp-encoded
                arr = arr.reshape(-1)
            flat_series.append(arr)

    answer_ids = [
        processor.tokenizer.encode(row["output"], add_special_tokens=False)[:max_answer_tokens]
        for row in rows
    ]
    if eos_token_id is None:
        eos_token_id = getattr(processor.tokenizer, "eos_token_id", None)
    if eos_token_id is not None:
        answer_ids = [ids + [eos_token_id] for ids in answer_ids]

    # Prompts through the processor (placeholder expansion included), then
    # padded to the bucket that fits the answers too.
    batch = processor(prompts, flat_series)
    b = batch.input_ids.shape[0]
    max_total = max(int(batch.seq_lens[i]) + len(answer_ids[i]) for i in range(b))
    t_total = bucket_tokens(max_total)

    input_ids = np.full((b, t_total), processor.pad_token_id, np.int32)
    attention_mask = np.zeros((b, t_total), np.int32)
    targets = np.zeros((b, t_total), np.int32)
    loss_mask = np.zeros((b, t_total), np.float32)
    for i in range(b):
        ln = int(batch.seq_lens[i])
        seq = list(batch.input_ids[i, :ln]) + answer_ids[i]
        total = len(seq)
        input_ids[i, :total] = seq
        attention_mask[i, :total] = 1
        targets[i, : total - 1] = seq[1:]
        # The answer's predictions sit at positions [ln - 1, total - 1).
        loss_mask[i, ln - 1 : total - 1] = 1.0

    positions = np.tile(np.arange(t_total, dtype=np.int32), (b, 1))
    return {
        "input_ids": input_ids,
        "positions": positions,
        "attention_mask": attention_mask,
        "targets": targets,
        "loss_mask": loss_mask,
        "ts_values": batch.ts_values,
        "ts_mask": batch.ts_mask,
        "scatter_seq": batch.scatter_seq,
        "scatter_tok": batch.scatter_tok,
    }


def batch_iterator(
    processor: ChatTSProcessor,
    rows: Sequence[dict],
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    **kw,
) -> Iterator[Dict[str, np.ndarray]]:
    order = np.arange(len(rows))
    rng = np.random.default_rng(seed)
    if shuffle:
        rng.shuffle(order)
    for start in range(0, len(order), batch_size):
        chunk = order[start : start + batch_size]
        if drop_last and len(chunk) < batch_size:
            break
        yield build_sft_batch(processor, [rows[i] for i in chunk], **kw)


def to_device(batch: Dict[str, np.ndarray], device="cuda") -> Dict[str, torch.Tensor]:
    """A batch's arrays as tensors on ``device``, their dtypes kept."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
