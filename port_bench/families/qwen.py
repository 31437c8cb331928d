"""The Qwen family: ChatTS on a Qwen2 (qkv bias) or Qwen3 (q/k RMSNorm, no
bias) decoder, int4 projections with the q/k/v and gate/up projections fused,
an int4 head.

Its weights (``make``), the port's model built from them (``port_model``),
the plain float32 reference with its float8 control (``logits``), the
dense grouped-query FLOPs of a request (``request_flops``), and the port's
kernels it launches with their bounds (``KERNELS``, ``spies``,
``mixed_launches``): ``int4_matmul`` (B3) for every projection and the head,
``flash_attention`` (B1) for prefill attention.

The reference: x + attn(rmsnorm(x)), then x + mlp(rmsnorm(x)); attention is
causal grouped-query attention with rotate-half RoPE (inverse frequencies
theta ** (-2i / head_dim)) at positions 0 .. T - 1; the MLP is
down(silu(gate(x)) * up(x)); a final RMSNorm and the head give the logits.
The series go through the patch encoder and each patch's embedding replaces
the embedding of its placeholder token (``reference/model.py``).  Every int4
projection is unpacked from the benchmark's bytes and multiplied by its group
scales in float32, one layer at a time, and the whole of every sequence is
computed: no cache.  ``lowered=True`` is the control, the reference computed a
precision below the bfloat16 the configurations state: every tensor the
program holds in bfloat16 (the merged embeddings, the residual stream after
each add, each norm's output, q, k and v, the attention output, each
projection's output, the MLP's activation) is rounded to float8 e4m3, each
row scaled by its largest magnitude over 448.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch
import torch.nn.functional as F

from port_bench import flops
from port_bench.reference.model import (
    Sequence_, causal_attention, full_f32, patch_embeddings, rms_norm, rope, to_fp8,
    unpack_int4)
from port_bench.weights import Draws, port_ts_encoder

KERNELS = {"int4": ("int4_mma_kernel", "int4_splitk_reduce_kernel"),
           "flash": ("flash_mma_kernel",)}


# -- weights and the port's model ---------------------------------------------

def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of configuration ``cfg`` (a ``configs/*.json`` dict) drawn
    from ``seed`` on ``device``.  Keys ending in ``.q4``/``.s4`` are packed
    int4 bytes and their scales, stacked over the layers on dim 0."""
    n, hid, inter = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"]
    h, kvh, d, vocab = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                        cfg["head_dim"], cfg["vocab_size"])
    draw = Draws(seed, device, n)
    g, bf16 = draw.g, torch.bfloat16
    w: Dict[str, torch.Tensor] = {}
    qkv = (h + 2 * kvh) * d
    for name, fan_in, fan_out in (("qkv", hid, qkv), ("o", h * d, hid),
                                  ("gate_up", hid, 2 * inter), ("down", inter, hid)):
        w[f"{name}.q4"] = draw.packed(n, fan_in, fan_out)
        w[f"{name}.s4"] = draw.scales(n, fan_in, fan_out, residual=name in ("o", "down"))
    if cfg["attention_bias"]:
        w["qkv.bias"] = (0.1 * torch.randn((n, qkv), generator=g, device=device)).to(bf16)
    if cfg["qk_norm"]:
        w["q_norm"] = draw.around_one(n, d)
        w["k_norm"] = draw.around_one(n, d)
    w["ln1"] = draw.around_one(n, hid)
    w["ln2"] = draw.around_one(n, hid)
    w["norm"] = draw.around_one(hid)
    w["embed"] = torch.randn((vocab, hid), generator=g, device=device, dtype=bf16)
    w["head.q4"] = draw.packed(0, hid, vocab)
    w["head.s4"] = draw.scales(0, hid, vocab)
    w.update(draw.ts_encoder(cfg["ts"]))
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
    encoder = port_ts_encoder(pcfg.ts, w, w["embed"].device)
    return pcfg, ChatTSModel(pcfg, encoder, llm)


# -- the plain reference --------------------------------------------------------

@torch.no_grad()
def final_hidden(cfg: dict, w: Dict[str, torch.Tensor], seqs: List[Sequence_],
                 lowered: bool = False) -> List[torch.Tensor]:
    """The final norm's output (len(wanted), hidden) float32 of every
    sequence, computed layer by layer over all of them (one layer's weights
    unpacked at a time): what the head multiplies."""
    dev = w["embed"].device
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    h, kvh, d = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    inter = cfg["intermediate_size"]

    def lo(x):
        return to_fp8(x) if lowered else x

    with full_f32():
        xs = []
        for s in seqs:
            x = w["embed"][torch.as_tensor(s.ids, device=dev)].float()
            for values, start in zip(s.values, s.starts):
                e = patch_embeddings(cfg, w, values, dev)
                x[start:start + e.shape[0]] = e
            xs.append(lo(x))
        for i in range(cfg["num_hidden_layers"]):
            wq = {n: unpack_int4(w[f"{n}.q4"][i], w[f"{n}.s4"][i])
                  for n in ("qkv", "o", "gate_up", "down")}
            for j, x in enumerate(xs):
                t = x.shape[0]
                qkv = lo(rms_norm(x, w["ln1"][i], eps)) @ wq["qkv"]
                if cfg["attention_bias"]:
                    qkv = qkv + w["qkv.bias"][i].float()
                q, k, v = lo(qkv).split([h * d, kvh * d, kvh * d], dim=-1)
                q, k, v = q.reshape(t, h, d), k.reshape(t, kvh, d), v.reshape(t, kvh, d)
                if cfg["qk_norm"]:
                    q = lo(rms_norm(q, w["q_norm"][i], eps))
                    k = lo(rms_norm(k, w["k_norm"][i], eps))
                q, k = lo(rope(q, theta)), lo(rope(k, theta))
                att = lo(causal_attention(q, k, v))
                x = lo(x + lo(att @ wq["o"]))
                gate, up = lo(lo(rms_norm(x, w["ln2"][i], eps)) @ wq["gate_up"]).split(
                    [inter, inter], dim=-1)
                xs[j] = lo(x + lo(lo(F.silu(gate) * up) @ wq["down"]))
            del wq
        return [lo(rms_norm(x[torch.as_tensor(s.wanted, device=dev)], w["norm"], eps))
                for s, x in zip(seqs, xs)]


@torch.no_grad()
def logits(cfg: dict, w: Dict[str, torch.Tensor], seqs: List[Sequence_],
           lowered: bool = False) -> List[torch.Tensor]:
    """The logits (len(wanted), vocab) float32 of every sequence: the int4
    head over ``final_hidden``."""
    hidden = final_hidden(cfg, w, seqs, lowered)
    with full_f32():
        head = unpack_int4(w["head.q4"], w["head.s4"])
        return [x @ head for x in hidden]


# -- FLOPs ------------------------------------------------------------------------

def layer_matmul_params(cfg: dict) -> int:
    """The projection weights of one decoder layer."""
    hid, inter = cfg["hidden_size"], cfg["intermediate_size"]
    h, kvh, d = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    return hid * (h + 2 * kvh) * d + h * d * hid + hid * 2 * inter + inter * hid


def head_flops(cfg: dict) -> float:
    return 2.0 * cfg["hidden_size"] * cfg["vocab_size"]


def prefill_flops(cfg: dict, prompt: int) -> float:
    """A whole prompt's prefill: every token, attending its causal prefix
    (4 head_dim a key and head), and the head once (the first token's
    logits)."""
    n, h, d = cfg["num_hidden_layers"], cfg["num_attention_heads"], cfg["head_dim"]
    return (prompt * n * 2.0 * layer_matmul_params(cfg)
            + n * 4.0 * h * d * flops.prefix_pairs([prompt]) + head_flops(cfg))


def decode_flops(cfg: dict, prompt: int, first: int, count: int) -> float:
    """Output tokens ``first`` .. ``first + count - 1`` (0 is the prefill's):
    token j runs output j - 1 at position prompt + j - 1, attending
    prompt + j keys, and the head."""
    n, h, d = cfg["num_hidden_layers"], cfg["num_attention_heads"], cfg["head_dim"]
    keys = flops.span_pairs(prompt + first - 1, prompt + first - 1 + count)
    return count * (n * 2.0 * layer_matmul_params(cfg) + head_flops(cfg)) + n * 4.0 * h * d * keys


def request_flops(cfg: dict, prompt: int, puts: Iterable[Tuple[float, int]]):
    """(time, FLOPs) of each delivery of one request's tokens: the first
    carries the prefill, the rest the decode steps that made them."""
    out, done = [], 0
    for t, n in puts:
        f = 0.0
        if done == 0:
            f += prefill_flops(cfg, prompt)
            if n > 1:
                f += decode_flops(cfg, prompt, 1, n - 1)
        else:
            f += decode_flops(cfg, prompt, done, n)
        out.append((t, f))
        done += n
    return out


# -- the kernels, for the traced run ------------------------------------------------

def spies(tracer) -> list:
    """Wrappers of the names ``models/qwen.py`` calls: ``int4_matmul``, each
    launch at its shape (a graph's launches at their capture's); ``attention``,
    eager prefill attention over a prompt block, whose bound waits for the
    trace's reading (its lengths are on the device); the scan-sliced round's
    is ``mixed_launches``'."""
    from chatts_tpu_torch.models import qwen

    int4, attention = qwen.int4_matmul, qwen.attention

    def int4_spy(x, packed, scales, *args, **kw):
        tracer.launch("int4", flops.int4_bound_s, x.shape[0], x.shape[1], packed.shape[1])
        return int4(x, packed, scales, *args, **kw)

    def attention_spy(q, k, v, **kw):
        if tracer.counts_eager():
            # A prompt block's prefill attends the block itself: queries and
            # keys at positions 0 .. T - 1, valid below each length.
            if kw.get("impl", "auto") == "auto" and q.shape[1] == k.shape[1]:
                tracer.eager("flash", _block_flash_bound, q.shape[2], k.shape[2], q.shape[3],
                             kw["kv_valid"])
            else:
                tracer.eager("flash", None)
        return attention(q, k, v, **kw)

    return [(qwen, "int4_matmul", int4_spy), (qwen, "attention", attention_spy)]


def _block_flash_bound(h: int, kvh: int, d: int, valid: torch.Tensor) -> float:
    lens = valid.sum(dim=1).tolist()
    return flops.flash_bound_s(h, kvh, d, sum(lens), sum(lens), flops.prefix_pairs(lens))


def mixed_launches(cfg: dict, engine) -> List[Tuple[str, int, float]]:
    """The prefill attention launches of the scan-sliced round about to
    run: ``decode_chunk`` steps, each taking ``npt`` prompt tokens of every
    row from the round's offset, each query attending its causal prefix, one
    launch a layer."""
    st = engine._pending_mixed
    lengths = [r.prompt_tokens for r in st["reqs"]]
    npt, o = st["npt"], st["o"]
    out = []
    for s in range(engine.decode_chunk):
        start = o + s * npt
        queries = sum(max(0, min(start + npt, n) - start) for n in lengths)
        keys = sum(min(n, start + npt) for n in lengths if start < n)
        pairs = sum(flops.span_pairs(start, min(start + npt, n)) for n in lengths)
        one = flops.flash_bound_s(cfg["num_attention_heads"], cfg["num_key_value_heads"],
                                  cfg["head_dim"], queries, keys, pairs)
        out.append(("flash", cfg["num_hidden_layers"], cfg["num_hidden_layers"] * one))
    return out
