"""Real-weight day rehearsal on the port: the counterpart of
``scripts/rehearse_real_checkpoint.py``.

Synthesizes a ChatTS-8B or 14B GPTQ-Int4 checkpoint directory in the
on-disk format the published exports use -- HF ``config.json``,
``model.safetensors.index.json`` with shards of about 1.8 GB, AutoGPTQ-v1
packed projections (``qweight``/``qzeros``/``scales``/``g_idx``), fp16
embeddings, norms and biases, and the TS encoder under the ``ts.*`` spelling
the HF remote-code export ships -- then drives the path a user takes to
serve it (reference contract: README.md:81-104, checkpoint naming
chatts/vllm/chatts_vllm.py:467-470,612-625):

    weights.diagnose()  ->  load_checkpoint(quantize_bits=4)  ->
    greedy tokens, twice, equal.

Nothing is downloaded: this proves everything but the download -- shard
streaming, the lossless GPTQ -> int4 conversion at full size, device
placement, and tokens from the loaded model. The weights are random, made
on the target device from a seed (``torch.Generator``).

Usage:
    python -m chatts_tpu_torch.scripts.rehearse_real_checkpoint              # 8B, sym
    python -m chatts_tpu_torch.scripts.rehearse_real_checkpoint --shape 14b
    python -m chatts_tpu_torch.scripts.rehearse_real_checkpoint --desc-act   # g_idx perm
    python -m chatts_tpu_torch.scripts.rehearse_real_checkpoint --asym       # zeros != 8
    python -m chatts_tpu_torch.scripts.rehearse_real_checkpoint --tiny --device cpu
    ... --dir DIR --keep                                                     # keep it
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Callable, List, Optional

import numpy as np
import torch

GROUP = 128
SHARD_BYTES = int(1.8e9)  # about 1.8 GB shards, like real multi-shard exports


def hf_config(shape: str, num_layers: Optional[int] = None) -> dict:
    """The HF ``config.json`` of a ``shape`` ("8b", "14b" or "tiny"), with
    ``num_layers`` decoder layers if given."""
    if shape == "8b":
        d = dict(hidden_size=3584, intermediate_size=18944, num_hidden_layers=28,
                 num_attention_heads=28, num_key_value_heads=4)
    elif shape == "14b":
        d = dict(hidden_size=5120, intermediate_size=13824, num_hidden_layers=48,
                 num_attention_heads=40, num_key_value_heads=8)
    elif shape == "tiny":  # a quick run: the shapes still tile the kernels (head_dim 128)
        d = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                 num_attention_heads=2, num_key_value_heads=1)
    else:
        raise ValueError(f"unknown shape {shape}")
    if num_layers is not None:
        d["num_hidden_layers"] = num_layers
    vocab = 152064 if shape != "tiny" else 1024
    d.update(
        architectures=["Qwen2TSForCausalLM"],
        model_type="qwen2_ts",
        vocab_size=vocab,
        head_dim=d["hidden_size"] // d["num_attention_heads"] if shape == "tiny" else 128,
        rms_norm_eps=1e-6,
        rope_theta=1e6,
        max_position_embeddings=32768,
        tie_word_embeddings=False,
        ts={"patch_size": 16, "num_layers": 5, "hidden_size": d["hidden_size"],
            "num_features": 2, "max_sequence_length": 4096},
        ts_token_start_index=vocab - 10,
        quantization_config={"bits": 4, "group_size": GROUP, "sym": True,
                             "desc_act": False, "quant_method": "gptq"},
    )
    return d


def synthesize(out_dir: str, shape: str = "8b", desc_act: bool = False, asym: bool = False,
               seed: int = 0, device="cuda", num_layers: Optional[int] = None,
               log: Callable[[str], None] = print) -> dict:
    """Write the checkpoint directory: config.json, sharded safetensors and
    the index. Tensors are made on ``device`` from ``seed``, layer by layer,
    and written a shard at a time, so the host holds about one shard.
    ``desc_act`` writes a permuted ``g_idx`` (activation-order export),
    ``asym`` zero-points other than 8. Returns the config, the tensor count,
    the shard count and the bytes written."""
    from chatts_tpu_torch.utils.safetensors_io import ShardedWriter

    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    hf = hf_config(shape, num_layers)
    hf["quantization_config"].update(desc_act=desc_act, sym=not asym)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf, f, indent=2)

    h, inter = hf["hidden_size"], hf["intermediate_size"]
    kvd = hf["num_key_value_heads"] * hf["head_dim"]
    qd = hf["num_attention_heads"] * hf["head_dim"]
    vocab = hf["vocab_size"]

    def randint(high: int, shape_) -> torch.Tensor:
        return torch.randint(0, high, shape_, generator=gen, device=device, dtype=torch.uint8)

    def fp16(shape_, scale: float = 0.02) -> torch.Tensor:
        return (torch.randn(shape_, generator=gen, device=device) * scale).half()

    writer = ShardedWriter(out_dir, SHARD_BYTES)

    def gptq_linear(key: str, in_dim: int, out_dim: int) -> None:
        groups = in_dim // GROUP
        # Random packed codes directly (eight nibbles an int32).
        writer.add(key + ".qweight", randint(256, (in_dim // 8, 4 * out_dim)).view(torch.int32))
        if asym:
            # Zero-points in [5, 11], stored minus one: nibbles in [4, 10].
            # A real asymmetric export's zero-points sit near the middle of
            # the codes for weights centred near zero; the codes here are
            # uniform and drawn apart from them, so zero-points far from 8
            # would give each group a large mean that real weights lack.
            nib = 4 + randint(7, (groups, out_dim // 2, 2))
            zeros = (nib[..., 0] | (nib[..., 1] << 4)).view(torch.int32)
        else:
            # Symmetric: every zero-point is 8, stored minus one -- 0x77777777.
            zeros = torch.full((groups, out_dim // 8), 0x77777777, dtype=torch.int32, device=device)
        writer.add(key + ".qzeros", zeros)
        # Scales sized so dequantized weights look like N(0, 1/in_dim)
        # (codes-8 has std about 4.6): the random forward stays sane.
        base = 0.22 / np.sqrt(in_dim)
        scales = base * (0.5 + torch.rand((groups, out_dim), generator=gen, device=device))
        writer.add(key + ".scales", scales.half())
        g_idx = torch.arange(groups, dtype=torch.int32, device=device).repeat_interleave(GROUP)
        if desc_act:
            # Balanced but non-trivial input -> group map.
            g_idx = g_idx[torch.randperm(in_dim, generator=gen, device=device)]
        writer.add(key + ".g_idx", g_idx)

    t0 = time.perf_counter()
    writer.add("model.embed_tokens.weight", fp16((vocab, h)))
    for i in range(hf["num_hidden_layers"]):
        lp = f"model.layers.{i}."
        gptq_linear(lp + "self_attn.q_proj", h, qd)
        gptq_linear(lp + "self_attn.k_proj", h, kvd)
        gptq_linear(lp + "self_attn.v_proj", h, kvd)
        gptq_linear(lp + "self_attn.o_proj", qd, h)
        gptq_linear(lp + "mlp.gate_proj", h, inter)
        gptq_linear(lp + "mlp.up_proj", h, inter)
        gptq_linear(lp + "mlp.down_proj", inter, h)
        writer.add(lp + "self_attn.q_proj.bias", fp16((qd,)))
        writer.add(lp + "self_attn.k_proj.bias", fp16((kvd,)))
        writer.add(lp + "self_attn.v_proj.bias", fp16((kvd,)))
        writer.add(lp + "input_layernorm.weight", torch.ones((h,), dtype=torch.float16))
        writer.add(lp + "post_attention_layernorm.weight", torch.ones((h,), dtype=torch.float16))
        writer.flush_if_full()
    writer.add("model.norm.weight", torch.ones((h,), dtype=torch.float16))
    writer.add("lm_head.weight", fp16((vocab, h)))
    # The TS encoder under the remote-code export's "ts." spelling, fp16 on
    # disk (loaded in f32).
    in_size = hf["ts"]["patch_size"]
    for i in range(hf["ts"]["num_layers"]):
        writer.add(f"ts.mlp.{2 * i}.weight", fp16((h, in_size), scale=0.05))
        writer.add(f"ts.mlp.{2 * i}.bias", torch.zeros((h,), dtype=torch.float16))
        in_size = h
    writer.close()
    seconds = time.perf_counter() - t0
    log(f"synthesized {shape} GPTQ checkpoint ({hf['num_hidden_layers']} layers"
        f"{', desc_act' if desc_act else ''}{', asym' if asym else ''}): "
        f"{len(writer.weight_map)} tensors, {len(writer.shards)} shards, "
        f"{writer.total_bytes / 1e9:.2f} GB, {seconds:.1f} s -> {out_dir}")
    return dict(config=hf, tensors=len(writer.weight_map), shards=len(writer.shards),
                bytes=writer.total_bytes, seconds=seconds)


class HashTokenizer:
    """A stand-in tokenizer for a checkpoint without tokenizer files: one id
    per whitespace word, by a hash, below the ``<ts>`` ids at the top of the
    vocabulary."""

    pad_token_id = 0
    eos_token_id = 1

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        v = self.vocab_size
        return [10 + (sum(w.encode()) * 31 + len(w)) % (v - 100) for w in text.split()]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return " ".join(f"t{int(i)}" for i in ids)


def rehearse(ckpt_dir: str, device="cuda", log: Callable[[str], None] = print) -> List[List[int]]:
    """diagnose -> load -> greedy tokens twice: the user's path, minus the
    download. Returns the tokens; raises if any step fails."""
    from chatts_tpu_torch.core.config import GenerationConfig
    from chatts_tpu_torch.models import weights
    from chatts_tpu_torch.processor.processor import ChatTSProcessor
    from chatts_tpu_torch.runtime.engine import InferenceEngine

    # 1. diagnose: the pre-flight lint a user runs on a fresh download.
    t0 = time.perf_counter()
    report = weights.diagnose(ckpt_dir)
    log(f"diagnose ({time.perf_counter() - t0:.1f} s):\n{report.summary()}")
    if not report.ok or report.gptq_projections == 0:
        raise RuntimeError("diagnose must pass and find GPTQ projections")

    # 2. load: streaming shards -> the int4 layout on the device.
    t0 = time.perf_counter()
    cfg, model = weights.load_checkpoint(ckpt_dir, quantize_bits=4, device=device)
    gb = sum(t.numel() * t.element_size()
             for t in list(model.parameters()) + list(model.buffers())) / 1e9
    log(f"load_checkpoint: {time.perf_counter() - t0:.1f} s, {gb:.2f} GB on {device}")
    q = model.llm.layers[0].self_attn.q_proj
    if q is None or q.kernel_q4 is None:
        raise RuntimeError("the GPTQ projections did not land on the int4 layout")

    # 3. greedy tokens, as a served request would produce them.
    proc = ChatTSProcessor(HashTokenizer(cfg.llm.vocab_size), cfg)
    engine = InferenceEngine(model, cfg, device=device)
    batch = proc(["analyze this metric <ts><ts/> now"], [np.sin(np.arange(256) / 10.0) * 5.0])
    gen = GenerationConfig(max_new_tokens=4, greedy=True)
    first = engine.generate(batch, gen)
    second = engine.generate(batch, gen)
    log(f"first tokens (greedy): {first.token_ids[0]}  ttft={first.ttft_s:.2f} s")
    if first.token_ids != second.token_ids:
        raise RuntimeError("greedy decode must be deterministic")
    log("REHEARSAL OK: diagnose -> load -> tokens")
    return first.token_ids


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", choices=["8b", "14b"], default="8b")
    ap.add_argument("--tiny", action="store_true", help="tiny shapes (a quick smoke run)")
    ap.add_argument("--desc-act", action="store_true",
                    help="write a permuted g_idx (activation-order export)")
    ap.add_argument("--asym", action="store_true", help="write zero-points other than 8")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dir", default=None, help="where to write (default: a temporary directory)")
    ap.add_argument("--keep", action="store_true", help="keep the synthesized directory")
    ap.add_argument("--synthesize-only", action="store_true")
    args = ap.parse_args(argv)
    out_dir = args.dir or tempfile.mkdtemp(prefix="chatts_rehearsal_")
    try:
        synthesize(out_dir, shape="tiny" if args.tiny else args.shape, desc_act=args.desc_act,
                   asym=args.asym, device=args.device)
        if not args.synthesize_only:
            rehearse(out_dir, device=args.device)
    finally:
        if not args.keep:
            shutil.rmtree(out_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
