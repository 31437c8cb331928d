"""Start the OpenAI-compatible ChatTS server on the port (the vLLM-server
path's analog).

The counterpart of ``examples/serve_openai.py``. Reference flow:
scripts/start_vllm_server.sh serving on :12345 with model name "chatts" and
at most 15 timeseries a prompt; the same surface here, over the port's
continuous-batching ``ServeEngine`` on the card (``--device cpu`` for a
local demo), with a warm-up at start unless ``--no-warmup``.

    python -m chatts_tpu_torch.examples.serve_openai --model CKPT --quantize-int4 --kv-int8

``build`` makes the (engine, server) pair from the arguments; ``main``
serves until interrupted. Left out, as TPU machinery: ``--pad-to-class``
(padding admission waves to bound compiled shapes; nothing here compiles per
shape) and ``--cpu`` (the JAX backend switch; ``--device cpu`` is its
counterpart). ``--prefill-chunk N`` admits every prompt longer than N tokens
through the scan-sliced mixed round, a slice of it each decode step.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default=None, help="checkpoint directory")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=12345)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--max-batch-size", type=int, default=8)
    parser.add_argument("--max-model-len", type=int, default=6144)
    parser.add_argument("--no-warmup", action="store_true")
    parser.add_argument("--quantize-int8", action="store_true",
                        help="int8 weight-only quantization at load")
    parser.add_argument("--quantize-int4", action="store_true",
                        help="int4 weight-only quantization (nibble-packed, group "
                             "scales, the int4 kernels); GPTQ-Int4 checkpoints "
                             "import losslessly")
    parser.add_argument("--kv-int8", action="store_true",
                        help="int8 KV cache (halves per-slot cache memory)")
    parser.add_argument("--prefill-act-int8", action="store_true",
                        help="int8 activations for prompt-side int4 matmuls "
                             "(decode stays bf16)")
    parser.add_argument("--prefill-chunk", type=int, default=None,
                        help="admit prompts longer than this in slices, inside "
                             "the decode rounds (scan-sliced mixed admission)")
    parser.add_argument("--decode-chunk", type=int, default=16,
                        help="decode steps per engine round")
    parser.add_argument("--admission-bucket", type=int, default=4,
                        help="max rows per admission wave")
    parser.add_argument("--no-admission-binning", action="store_true",
                        help="disable length-classed admission waves (pure FIFO)")
    parser.add_argument("--early-first-token", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="stream each request's first token right after its "
                             "prompt block instead of after the admission round's "
                             "decode chunk")
    return parser.parse_args(argv)


def build(args: argparse.Namespace, loaded=None):
    """(engine, server) for ``args``: the model from ``--model`` (or
    ``loaded``, a (cfg, model, tokenizer) the caller has already loaded; or
    a tiny random model without either), the engine with the serving flags,
    warmed up unless ``--no-warmup``, and a server that is not started yet
    (``server.start_background()`` or ``serve_forever()``)."""
    from chatts_tpu_torch.models import weights
    from chatts_tpu_torch.processor.processor import ChatTSProcessor
    from chatts_tpu_torch.serve.scheduler import ServeEngine
    from chatts_tpu_torch.serve.server import ChatTSServer

    device = torch.device(args.device)
    quant_bits = 4 if args.quantize_int4 else (8 if args.quantize_int8 else None)
    if loaded is not None:
        cfg, model, tokenizer = loaded
    elif args.model:
        cfg, model = weights.load_checkpoint(args.model, device=device, quantize_bits=quant_bits)
        tokenizer = weights.load_tokenizer(args.model)
        if tokenizer is None:
            raise SystemExit("checkpoint has no tokenizer files")
    else:
        from chatts_tpu_torch.examples.quickstart import tiny_demo

        print("[serve] no --model; tiny-random ChatTS for demonstration")
        cfg, model, tokenizer = tiny_demo(device)
    eos = tuple(t for t in (getattr(tokenizer, "eos_token_id", None),) if t)

    engine = ServeEngine(
        model, cfg, ChatTSProcessor(tokenizer, cfg),
        device=device,
        max_batch_size=args.max_batch_size,
        max_model_len=args.max_model_len,
        eos_token_ids=eos,
        cache_dtype=torch.int8 if args.kv_int8 else torch.bfloat16,
        decode_chunk=args.decode_chunk,
        prefill_chunk=args.prefill_chunk,
        fuse=not quant_bits,
        prefill_act_int8=args.prefill_act_int8,
        admission_bucket=args.admission_bucket,
        admission_binning=not args.no_admission_binning,
        block_early_emit=args.early_first_token,
    )
    if not args.no_warmup:
        print("[serve] warming up the admission shapes...")
        engine.warmup()
    return engine, ChatTSServer(engine, tokenizer, host=args.host, port=args.port)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    engine, server = build(args)
    print(f"[serve] listening on {args.host}:{args.port} (model name 'chatts')")
    try:
        server.serve_forever()
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
