"""Random int4 weights made on the device from the run's seed, and the port's
model built from them.

The weights are made in the layout they are served in, a few large calls a
kind (every layer's tensor of one kind in one call), as plain tensors in a
dict: int4 projections as packed bytes (IN/2, OUT) int8, byte row i holding
logical row 2i in its low nibble and 2i + 1 in its high one, with float32
scales (IN/128, OUT), one per group of 128 input rows; norms, biases and the
embedding table in bfloat16; the TS encoder in float32.  The same tensors go
to the reference (``reference/model.py``, which unpacks them with its own
code) and, through the port's public constructors, to the port.

Scales, norms and biases are drawn away from constants, so that a kernel or a
model that skips one of them, or applies the wrong group, shows in the
comparison.  The draws keep the model from collapsing onto one direction, as
random deep transformers do, where every position's logits are nearly the
same and a comparison of greedy tokens tests nothing:
- int4 codes are uniform over the symmetric [-7, 7] (mean 0, as a symmetric
  quantizer's are; uniform bytes would give codes in [-8, 7], whose mean of
  -1/2 adds one shared direction to every projection's output);
- the embeddings have unit scale, so that the token at each position is not
  drowned by what the layers add;
- the output projections of attention and MLP are scaled by 1 / sqrt(2
  layers), as GPT-2 initialises the projections into the residual stream.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

GROUP = 128


def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of configuration ``cfg`` (a ``configs/*.json`` dict) drawn
    from ``seed`` on ``device``.  Keys ending in ``.q4``/``.s4`` are packed
    int4 bytes and their scales, stacked over the layers on dim 0."""
    g = torch.Generator(device=device).manual_seed((int(seed) * 1_000_003) % (1 << 63))
    n, hid, inter = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"]
    h, kvh, d, vocab = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                        cfg["head_dim"], cfg["vocab_size"])
    bf16 = torch.bfloat16

    def packed(layers, fan_in, fan_out):
        """Bytes of two codes uniform over [-7, 7]: k uniform over the 225
        pairs, low code c = k % 15 - 7 and high code k // 15 - 7, each
        stored as its nibble c & 15 = (c + 7 + 9) & 15.  About 1 GiB of
        bytes a call, to bound the temporaries."""
        shape = (fan_in // 2, fan_out)
        out = torch.empty((max(layers, 1),) + shape, dtype=torch.uint8, device=device)
        step = max(1, (1 << 30) // (shape[0] * shape[1]))
        for i in range(0, out.shape[0], step):
            k = torch.randint(0, 225, out[i:i + step].shape, generator=g, device=device,
                              dtype=torch.uint8)
            lo = (k % 15 + 9) & 15
            out[i:i + step] = lo | (((k // 15 + 9) & 15) << 4)
        out = out.view(torch.int8)
        return out if layers else out[0]

    def scales(layers, fan_in, fan_out, residual=False):
        # Codes have standard deviation 4.3; a scale of about 1 / (7
        # sqrt(fan_in)) keeps a projection's output near its input's size.
        shape = (layers, fan_in // GROUP, fan_out) if layers else (fan_in // GROUP, fan_out)
        u = torch.rand(shape, generator=g, device=device)
        s = (0.5 + u) / (7.0 * math.sqrt(fan_in))
        return s / math.sqrt(2 * n) if residual else s

    def around_one(*shape):
        return (0.5 + torch.rand(shape, generator=g, device=device)).to(bf16)

    w: Dict[str, torch.Tensor] = {}
    qkv = (h + 2 * kvh) * d
    for name, fan_in, fan_out in (("qkv", hid, qkv), ("o", h * d, hid),
                                  ("gate_up", hid, 2 * inter), ("down", inter, hid)):
        w[f"{name}.q4"] = packed(n, fan_in, fan_out)
        w[f"{name}.s4"] = scales(n, fan_in, fan_out, residual=name in ("o", "down"))
    if cfg["attention_bias"]:
        w["qkv.bias"] = (0.1 * torch.randn((n, qkv), generator=g, device=device)).to(bf16)
    if cfg["qk_norm"]:
        w["q_norm"] = around_one(n, d)
        w["k_norm"] = around_one(n, d)
    w["ln1"] = around_one(n, hid)
    w["ln2"] = around_one(n, hid)
    w["norm"] = around_one(hid)
    w["embed"] = torch.randn((vocab, hid), generator=g, device=device, dtype=bf16)
    w["head.q4"] = packed(0, hid, vocab)
    w["head.s4"] = scales(0, hid, vocab)
    ts = cfg["ts"]
    sizes = [ts["patch_size"]] + [ts["hidden_size"]] * ts["num_layers"]
    for i in range(ts["num_layers"]):
        w[f"ts.{i}.kernel"] = (torch.randn((sizes[i], sizes[i + 1]), generator=g, device=device)
                               / math.sqrt(sizes[i]))
        w[f"ts.{i}.bias"] = 0.02 * torch.randn((sizes[i + 1],), generator=g, device=device)
    return w


def port_config(cfg: dict):
    """The port's ``ChatTSConfig`` for configuration ``cfg``."""
    from chatts_tpu_torch.core.config import ChatTSConfig, QwenConfig, TSEncoderConfig

    ts = cfg["ts"]
    return ChatTSConfig(
        llm=QwenConfig(
            vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            num_key_value_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
            rms_norm_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
            max_position_embeddings=cfg["max_position_embeddings"],
            tie_word_embeddings=cfg["tie_word_embeddings"],
            attention_bias=cfg["attention_bias"], qk_norm=cfg["qk_norm"],
            dtype="bfloat16",
        ),
        ts=TSEncoderConfig(patch_size=ts["patch_size"], num_layers=ts["num_layers"],
                           hidden_size=ts["hidden_size"],
                           max_sequence_length=ts["max_sequence_length"]),
        ts_token_start_index=cfg["ts_token_start_index"],
    )


def port_model(cfg: dict, w: Dict[str, torch.Tensor]):
    """The port's ``ChatTSModel`` holding the tensors of ``w`` (no copy):
    fused qkv and gate/up int4 projections, an int4 head."""
    from chatts_tpu_torch.models.chatts import ChatTSModel
    from chatts_tpu_torch.models.qwen import MLP, Attention, DecoderLayer, Dense, QwenModel
    from chatts_tpu_torch.models.ts_encoder import TSEncoder

    pcfg = port_config(cfg)
    layers = []
    for i in range(cfg["num_hidden_layers"]):
        def dense(name, bias=None):
            return Dense(kernel_q4=w[f"{name}.q4"][i], scales4=w[f"{name}.s4"][i], bias=bias)

        norms = ({"q_norm": w["q_norm"][i], "k_norm": w["k_norm"][i]}
                 if cfg["qk_norm"] else {})
        bias = w["qkv.bias"][i] if cfg["attention_bias"] else None
        layers.append(DecoderLayer(
            pcfg.llm,
            Attention(pcfg.llm, dense("o"), qkv_proj=dense("qkv", bias), **norms),
            MLP(dense("down"), gate_up_proj=dense("gate_up")),
            w["ln1"][i], w["ln2"][i]))
    llm = QwenModel(pcfg.llm, w["embed"], layers, w["norm"],
                    lm_head_q=Dense(kernel_q4=w["head.q4"], scales4=w["head.s4"]))
    encoder = TSEncoder(pcfg.ts, device=w["embed"].device)
    with torch.no_grad():
        for i in range(pcfg.ts.num_layers):
            encoder.kernels[i].copy_(w[f"ts.{i}.kernel"])
            encoder.biases[i].copy_(w[f"ts.{i}.bias"])
    return pcfg, ChatTSModel(pcfg, encoder, llm)
