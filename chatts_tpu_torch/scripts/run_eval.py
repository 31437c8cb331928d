"""Batch evaluation of a ChatTS checkpoint on the port: answers for every
sample of an eval dataset, then their scores.

The counterpart of ``scripts/run_eval.sh`` (reference flow: python3 -m
chatts.utils.inference_tsmllm_vllm, then python3 -m
evaluation.evaluate_tsmllm_models):

    python -m chatts_tpu_torch.scripts.run_eval DATASET MODEL [EXP]

It loads MODEL with ``weights.from_pretrained``, serves it with a
``ServeEngine`` that stops at the tokenizer's EOS, answers every sample
through ``LLMClient("tpu-ts")`` at the reference eval envelope (max_tokens
512, temperature 0.2), then scores the answers with the judge that
``judge_config.load_judge`` finds (rule scores only without one) and prints
the summary. The answers go to ``EXP_ROOT/EXP/generated_answer.json``, the
scores to ``result.json`` and ``detailed_result.json`` beside it. It runs on
the card unless ``--device cpu``; with the default device and no card it
stops. DATASET is a dataset_a-style JSON list, as
``python -m chatts_tpu_torch.eval.make_eval_dataset`` writes one.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dataset", help="eval dataset JSON")
    parser.add_argument("model", help="checkpoint directory (unused when the caller "
                                      "passes a loaded model)")
    parser.add_argument("exp", nargs="?", default="chatts_eval", help="experiment name")
    parser.add_argument("--exp-root", default="exp")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--max-tokens", type=int, default=512)
    parser.add_argument("--max-batch-size", type=int, default=8, help="engine slots")
    parser.add_argument("--max-model-len", type=int, default=6144)
    parser.add_argument("--decode-chunk", type=int, default=8,
                        help="decode steps per engine round")
    parser.add_argument("--kv-int8", action="store_true", help="int8 KV cache")
    parser.add_argument("--early-first-token", action="store_true",
                        help="stream each request's first token right after its "
                             "prompt block")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, loaded=None) -> dict:
    """Run the evaluation; returns the summary it prints. ``loaded`` is a
    (cfg, model, tokenizer) the caller has already built, in place of
    loading MODEL."""
    from chatts_tpu_torch.eval.inference import (evaluate_experiment, load_eval_dataset,
                                                 run_inference)
    from chatts_tpu_torch.eval.judge_config import load_judge
    from chatts_tpu_torch.eval.scorers import null_judge
    from chatts_tpu_torch.models import weights
    from chatts_tpu_torch.processor.processor import ChatTSProcessor
    from chatts_tpu_torch.serve.scheduler import ServeEngine
    from chatts_tpu_torch.utils.llm_client import LLMClient

    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to evaluate on the CPU")
    dataset = load_eval_dataset(args.dataset)
    if loaded is not None:
        cfg, model, tokenizer = loaded
    else:
        cfg, model, tokenizer = weights.from_pretrained(args.model, device=device)
        if tokenizer is None:
            raise SystemExit(f"checkpoint {args.model} has no tokenizer files")
    engine = ServeEngine(model, cfg, ChatTSProcessor(tokenizer, cfg), device=device,
                         max_batch_size=args.max_batch_size,
                         max_model_len=args.max_model_len,
                         cache_dtype=torch.int8 if args.kv_int8 else torch.bfloat16,
                         decode_chunk=args.decode_chunk,
                         eos_token_ids=(tokenizer.eos_token_id,),
                         block_early_emit=args.early_first_token)
    client = LLMClient(engine="tpu-ts", serve_engine=engine,
                       sampling_params={"max_tokens": args.max_tokens,
                                        "temperature": 0.2})
    try:
        run_inference(dataset, client, args.exp, exp_root=args.exp_root,
                      patch_size=cfg.ts.patch_size)
    finally:
        client.kill()
    summary = evaluate_experiment(dataset, args.exp, exp_root=args.exp_root,
                                  judge=load_judge() or null_judge)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
