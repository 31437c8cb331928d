"""Quickstart: load a ChatTS checkpoint and analyze a series, on the port.

The counterpart of ``examples/quickstart.py`` (reference: README.md:80-104):
a raw prompt with a ``<ts><ts/>`` hole and a raw numpy series -> the
processor -> ``InferenceEngine.generate``, on the card unless ``--device
cpu``. Point ``--model`` at a ChatTS HF checkpoint directory with tokenizer
files; without one, a tiny random int4 model with a hash tokenizer shows the
whole path.

    python -m chatts_tpu_torch.examples.quickstart --model CKPT
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch


def tiny_demo(device):
    """(cfg, model, tokenizer): a tiny random ChatTS in the int4 layout on
    ``device`` (its shapes tile the kernels: head_dim 128, projections
    multiples of 128), with a hash tokenizer."""
    from chatts_tpu_torch.core.config import tiny_config
    from chatts_tpu_torch.models.quantize import init_quantized_params
    from chatts_tpu_torch.scripts.rehearse_real_checkpoint import HashTokenizer

    cfg = tiny_config(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_attention_heads=2, num_key_value_heads=1, patch_size=16,
                      max_sequence_length=1024)
    model = init_quantized_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    return cfg, model, HashTokenizer(cfg.llm.vocab_size)


def main(argv: Optional[Sequence[str]] = None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default=None, help="checkpoint directory")
    parser.add_argument("--max-new-tokens", type=int, default=128)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from chatts_tpu_torch.core.config import GenerationConfig
    from chatts_tpu_torch.models import weights
    from chatts_tpu_torch.processor.processor import ChatTSProcessor
    from chatts_tpu_torch.runtime.engine import InferenceEngine

    device = torch.device(args.device)
    if args.model:
        cfg, model, tokenizer = weights.from_pretrained(args.model, device=device)
        if tokenizer is None:
            raise SystemExit("checkpoint has no tokenizer files")
        eos = tuple(t for t in (tokenizer.eos_token_id,) if t is not None)
    else:
        print("[quickstart] no --model given; using a tiny-random ChatTS")
        cfg, model, tokenizer = tiny_demo(device)
        eos = ()

    processor = ChatTSProcessor(tokenizer, cfg)
    engine = InferenceEngine(model, cfg, device=device)

    # The reference README's example series: a sine with a level shift.
    timeseries = np.sin(np.arange(256) / 10) * 5.0
    timeseries[100:] -= 10.0
    prompt = ("I have a time series length of 256: <ts><ts/>. Please analyze "
              "the local changes in this time series.")
    prompt = ("<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
              f"<|im_start|>user\n{prompt}<|im_end|>\n<|im_start|>assistant\n")

    batch = processor([prompt], [timeseries])
    result = engine.generate(batch, GenerationConfig(
        max_new_tokens=args.max_new_tokens, greedy=True, eos_token_ids=eos))
    text = tokenizer.decode(result.token_ids[0], skip_special_tokens=True)
    print(f"TTFT {result.ttft_s * 1e3:.0f} ms, TPOT {result.tpot_s * 1e3:.2f} ms "
          f"on {device}")
    print("---")
    print(text)
    return text


if __name__ == "__main__":
    main()
