"""Checkpoint I/O: HF safetensors directories <-> the port's ``ChatTSModel``.

The port of ``chatts_tpu/models/weights.py``. Tensors stream from the
safetensors shards (``utils/safetensors_io.py``: memory-mapped, one tensor
read at a time) straight to ``device``, and are cast and quantized there,
so the host holds about one tensor and the card the quantized model plus
the tensor being converted.

With a ``mesh`` each rank reads only its shard of each tensor (the layout
of ``parallel/sharding.py``: a column-parallel projection's output rows of
the HF weight, a row-parallel one's input columns, its groups for GPTQ) and
converts it on its device; the result is bit-equal to ``place_params`` of
the whole load. Two reads are wider: an int8 row shard takes each column's
maximum over tp (one collective), and a GPTQ projection that does not
convert natively (and an activation-order row shard, whose rows are spread
over ``qweight``) is read whole, then cut. The reference loads checkpoints through vLLM's AutoWeightsLoader
with a prefix mapper (reference: chatts/vllm/chatts_vllm.py:467-470,612-625)
or HF ``from_pretrained`` remote code; the naming variants of both load here.

Tied-embedding detection matches the reference: if ``lm_head.weight`` is
absent, logits reuse the embedding table (chatts_vllm.py:621-624).

GPTQ-Int4 projections with ``quantize_bits=4`` land on the int4 kernels'
layout losslessly (``models/gptq.py::to_native_int4``) and stay unfused, as
the reference server keeps them. An export whose group size is not 128 is
dequantized and requantized at group 128 instead (lossy; the JAX package
imports any group its TPU tile planner fits).

Diagnose a directory before loading it:

    python -m chatts_tpu_torch.models.weights CKPT
"""
from __future__ import annotations

import dataclasses
import difflib
import json
import os
import sys
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from chatts_tpu_torch.core.config import ChatTSConfig
from chatts_tpu_torch.models import gptq
from chatts_tpu_torch.models import ts_encoder as ts_encoder_lib
from chatts_tpu_torch.models.chatts import ChatTSModel
from chatts_tpu_torch.models.qwen import MLP, Attention, DecoderLayer, Dense, QwenModel
from chatts_tpu_torch.models.quantize import _int4_tiles, quantize_dense
from chatts_tpu_torch.ops.int4_matmul import DEFAULT_GROUP, pack_int4
from chatts_tpu_torch.parallel import sharding
from chatts_tpu_torch.utils import safetensors_io

TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "vocab.json")
# The head is quantized this many output columns at a time (see _quantize_head).
HEAD_COLUMNS = 16384


class LazyStateDict:
    """Dict-like view over one or many safetensors shards; a tensor is read
    when it is asked for and is not retained."""

    def __init__(self, model_path: str):
        self.model_path = model_path
        self._files: Dict[str, safetensors_io.SafetensorsFile] = {}
        self._name_to_file: Dict[str, str] = {}
        index_path = os.path.join(model_path, safetensors_io.INDEX_NAME)
        if os.path.exists(index_path):
            with open(index_path) as f:
                self._name_to_file = dict(json.load(f)["weight_map"])
        else:
            single = safetensors_io.SINGLE_NAME
            if not os.path.exists(os.path.join(model_path, single)):
                raise FileNotFoundError(f"no model.safetensors[.index.json] under {model_path}")
            self._name_to_file = {name: single for name in self._file(single).keys()}

    def _file(self, fname: str) -> safetensors_io.SafetensorsFile:
        if fname not in self._files:
            self._files[fname] = safetensors_io.SafetensorsFile(
                os.path.join(self.model_path, fname))
        return self._files[fname]

    def __contains__(self, name: str) -> bool:
        return name in self._name_to_file

    def keys(self):
        return self._name_to_file.keys()

    def get_tensor(self, name: str, device=None) -> torch.Tensor:
        return self._file(self._name_to_file[name]).get(name, device)

    def get_slice(self, name: str, dim: int, start: int, stop: int,
                  device=None) -> torch.Tensor:
        """``[start, stop)`` of dimension ``dim`` of a tensor; only those
        bytes are read."""
        return self._file(self._name_to_file[name]).get_slice(name, dim, start, stop, device)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.get_tensor(name)

    def shape(self, name: str) -> Tuple[int, ...]:
        """Tensor shape from the safetensors header; no data is read."""
        return self._file(self._name_to_file[name]).shape(name)

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _key_candidates(name: str) -> Iterator[str]:
    """Checkpoint naming variants for one logical HF-style key.

    The reference's vLLM mapper rewrites ``lm_head.* -> language_model.lm_head.*``
    and ``model.* -> language_model.model.*`` (chatts_vllm.py:467-470), and the
    TS encoder may sit at top level or under ``model.`` depending on which side
    of ``from_pretrained`` the checkpoint was saved from.  The encoder module
    itself is ``self.ts_encoder`` in the reference's vLLM classes
    (chatts_vllm.py:480,661) but the HF remote-code export has also shipped it
    as ``ts.*`` (the config sub-dict's name) -- both spellings are accepted at
    every prefix, so a real ChatTS-8B/14B export loads whatever its provenance.
    """
    names = [name]
    if name.startswith("ts_encoder."):
        names.append("ts." + name[len("ts_encoder."):])
    for n in names:
        yield n
        if n.startswith("model."):
            yield n[len("model."):]
            yield "language_model." + n
        else:
            yield "model." + n
            yield "language_model." + n


class ResolvedStateDict:
    """View over a LazyStateDict that resolves logical keys through the
    naming variants above and records which physical keys were consumed
    (for the conversion lint)."""

    def __init__(self, sd: LazyStateDict):
        self._sd = sd
        self.used: set = set()

    def resolve(self, name: str) -> Optional[str]:
        for cand in _key_candidates(name):
            if cand in self._sd:
                return cand
        return None

    def __contains__(self, name: str) -> bool:
        return self.resolve(name) is not None

    def keys(self):
        return self._sd.keys()

    def _actual(self, name: str) -> str:
        actual = self.resolve(name)
        if actual is None:
            raise KeyError(name)
        return actual

    def get_tensor(self, name: str, device=None) -> torch.Tensor:
        actual = self._actual(name)
        self.used.add(actual)
        return self._sd.get_tensor(actual, device)

    def get_slice(self, name: str, dim: int, start: int, stop: int,
                  device=None) -> torch.Tensor:
        actual = self._actual(name)
        self.used.add(actual)
        return self._sd.get_slice(actual, dim, start, stop, device)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.get_tensor(name)

    def shape(self, name: str) -> Tuple[int, ...]:
        return self._sd.shape(self._actual(name))


def detect_tied_embeddings(sd) -> bool:
    return "lm_head.weight" not in sd


def load_checkpoint(
    model_path: str,
    cfg: Optional[ChatTSConfig] = None,
    *,
    dtype=torch.bfloat16,
    device="cuda",
    quantize_bits: Optional[int] = None,
    mesh=None,
) -> Tuple[ChatTSConfig, ChatTSModel]:
    """Load a ChatTS HF checkpoint directory into (config, model) on
    ``device`` (the card unless the caller asks for the CPU).

    Decoder tensors are cast to ``dtype``; the TS encoder is f32. With
    ``quantize_bits=8`` every projection is quantized per column as it
    streams in, with ``quantize_bits=4`` to the int4 kernels' layout (int8
    where a shape does not tile), and the separate head into ``lm_head_q``.
    GPTQ-Int4 projections convert to int4 losslessly with bits 4
    (``gptq.to_native_int4``), and are dequantized otherwise. A ``cfg`` with
    fewer layers than the checkpoint loads its first layers. With ``mesh``
    (``parallel/mesh.py``) the model is this rank's tensor-parallel shard,
    read and converted as the module docstring says."""
    if quantize_bits not in (None, 4, 8):
        raise ValueError(f"quantize_bits must be 4 or 8, got {quantize_bits}")
    if cfg is None:
        cfg = ChatTSConfig.from_pretrained(model_path)
    device = torch.device(device)
    # Fail before any tensor data or device work, with the full expected-vs-
    # found report, instead of a bare KeyError mid-stream.
    report = diagnose(model_path, cfg)
    if not report.ok:
        raise ValueError(
            f"checkpoint at {model_path} does not match the loader contract; run "
            f"python -m chatts_tpu_torch.models.weights {model_path} for details.\n"
            f"{report.summary()}")
    with LazyStateDict(model_path) as lazy:
        sd = ResolvedStateDict(lazy)
        tied = detect_tied_embeddings(sd)
        if tied != cfg.llm.tie_word_embeddings:
            cfg = dataclasses.replace(
                cfg, llm=dataclasses.replace(cfg.llm, tie_word_embeddings=tied))
        llm = _Reader(sd, dtype, device, quantize_bits, mesh).llm(cfg.llm, tied)
        # TS encoder: f32 for numerical parity on value-QA (SURVEY §7).
        encoder = ts_encoder_lib.load_torch_state_dict(sd, cfg.ts, device=device)
    model = ChatTSModel(cfg, encoder, llm)
    if mesh is not None:
        sharding.check_kernel_shapes(model, device)
    return cfg, model


class _Reader:
    """The decoder of a checkpoint, read a tensor at a time: whole, or on a
    ``mesh`` this rank's shard of each tensor (the module docstring).  One
    path for both: a unit the mesh does not split (every unit without one)
    is read whole, and a shard takes the format the whole layer's shape
    decides."""

    def __init__(self, sd, dtype, device, quantize_bits, mesh):
        self.sd, self.dtype, self.device = sd, dtype, device
        self.bits, self.mesh = quantize_bits, mesh

    def part(self, name: str, dim: Optional[int]) -> torch.Tensor:
        """This rank's range of dimension ``dim`` of a tensor (all of it
        for None), in the dtype."""
        if dim is None:
            return self.sd.get_tensor(name, self.device).to(self.dtype)
        start, stop = sharding.shard_range(self.sd.shape(name)[dim], self.mesh)
        return self.sd.get_slice(name, dim, start, stop, self.device).to(self.dtype)

    def dims(self, name: str) -> Tuple[int, int]:
        """(IN, OUT) of the whole projection at ``name``."""
        if name + ".weight" in self.sd:
            out_dim, in_dim = self.sd.shape(name + ".weight")
            return in_dim, out_dim
        return 8 * self.sd.shape(name + ".qweight")[0], self.sd.shape(name + ".scales")[1]

    def int4_groups(self, name: str) -> Optional[int]:
        """The projection's int4 groups once loaded, None unless int4."""
        in_dim, out_dim = self.dims(name)
        return in_dim // DEFAULT_GROUP if self.bits == 4 and _int4_tiles(in_dim, out_dim) else None

    def quantized(self, kernel: torch.Tensor, bias, kind: str, in_dim: int,
                  out_dim: int) -> Dense:
        """A (shard's) kernel in the format the whole (in_dim, out_dim)
        layer's shape decides: int4 where it tiles with bits 4, else int8
        with bits 4 or 8, else float."""
        shard = dict(bias=bias, mesh=self.mesh, tp_kind=kind)
        if self.bits == 4 and _int4_tiles(in_dim, out_dim):
            packed, scales = pack_int4(kernel)
            return Dense(kernel_q4=packed, scales4=scales, **shard)
        if self.bits in (4, 8):
            q = quantize_dense(Dense(kernel), self.mesh if kind == "row" else None)
            return Dense(kernel_q=q.kernel_q, scales=q.scales, **shard)
        return Dense(kernel, **shard)

    def dense(self, name: str, bias: bool, kind: str) -> Dense:
        """The projection at ``name``: whole (``kind`` "") or this rank's
        "col" or "row" shard."""
        sd = self.sd

        def dim(field: str) -> Optional[int]:
            return sharding.shard_dim(kind, field) if kind else None

        b = self.part(name + ".bias", dim("bias")) if bias and name + ".bias" in sd else None
        in_dim, out_dim = self.dims(name)
        if name + ".weight" in sd:  # HF's (out, in): the kernel transposed
            kdim = dim("kernel")
            kernel = self.part(name + ".weight", None if kdim is None else 1 - kdim)
            return self.quantized(kernel.t().contiguous(), b, kind, in_dim, out_dim)
        if not gptq.has_gptq_tensors(sd, name):
            raise KeyError(f"{name}: neither .weight nor .qweight found")
        if self.bits == 4:
            index, count = (self.mesh.tp_index, self.mesh.tp) if kind else (0, 1)
            native = gptq.to_native_int4(sd, name, self.device, kind, index, count)
            if native is not None:
                return Dense(**native, bias=b, mesh=self.mesh, tp_kind=kind)
        # f32 first, as the JAX package takes the f64 result.
        kernel = torch.from_numpy(gptq.load_gptq_kernel(sd, name).astype(np.float32))
        kernel = kernel.to(device=self.device, dtype=self.dtype)
        if kind:
            start, stop = sharding.shard_range(kernel.shape[dim("kernel")], self.mesh)
            kernel = kernel.narrow(dim("kernel"), start, stop - start).contiguous()
        return self.quantized(kernel, b, kind, in_dim, out_dim)

    def layers(self, lcfg) -> list:
        """The decoder layers, in the reference loader's order of reads; a
        unit that tp does not divide (``parallel/sharding.py``) whole."""
        mesh, out = self.mesh, []
        for i in range(lcfg.num_hidden_layers):
            lp = f"model.layers.{i}."
            attn = lp + "self_attn."
            input_norm = self.part(lp + "input_layernorm.weight", None)
            post_norm = self.part(lp + "post_attention_layernorm.weight", None)
            a = sharding.attention_sharded(lcfg, mesh, self.int4_groups(attn + "o_proj"))
            col, row = ("col", "row") if a else ("", "")
            projs = {p: self.dense(attn + p, lcfg.attention_bias, col)
                     for p in ("q_proj", "k_proj", "v_proj")}
            o = self.dense(attn + "o_proj", False, row)
            m = sharding.mlp_sharded(lcfg, mesh, self.int4_groups(lp + "mlp.down_proj"))
            mcol, mrow = ("col", "row") if m else ("", "")
            gate = self.dense(lp + "mlp.gate_proj", False, mcol)
            up = self.dense(lp + "mlp.up_proj", False, mcol)
            down = self.dense(lp + "mlp.down_proj", False, mrow)
            norms = {}
            if lcfg.qk_norm:
                norms = {"q_norm": self.part(attn + "q_norm.weight", None),
                         "k_norm": self.part(attn + "k_norm.weight", None)}
            heads = (dict(num_heads=lcfg.num_attention_heads // mesh.tp,
                          num_kv_heads=lcfg.num_key_value_heads // mesh.tp, mesh=mesh)
                     if a else {})
            out.append(DecoderLayer(
                lcfg, Attention(lcfg, o, **projs, **norms, **heads),
                MLP(down, gate_proj=gate, up_proj=up), input_norm, post_norm))
        return out

    def llm(self, lcfg, tied: bool) -> QwenModel:
        layers = self.layers(lcfg)
        vocab = sharding.vocab_sharded(lcfg, self.mesh)
        kind = "col" if vocab else ""
        embed = self.part("model.embed_tokens.weight", 0 if vocab else None)
        lm_head = lm_head_q = None
        if not tied:
            weight = self.part("lm_head.weight", 0 if vocab else None)  # (vocab, hidden)
            if self.bits is None:
                lm_head = weight.t().contiguous()
            else:
                hidden, vocab_size = lcfg.hidden_size, lcfg.vocab_size
                lm_head_q = _quantize_head(
                    weight, lambda k: self.quantized(k, None, kind, hidden, vocab_size))
        start = sharding.shard_range(lcfg.vocab_size, self.mesh)[0] if vocab else None
        return QwenModel(lcfg, embed, layers, self.part("model.norm.weight", None),
                         lm_head=lm_head, lm_head_q=lm_head_q, mesh=self.mesh, vocab_start=start)


def _quantize_head(weight: torch.Tensor, quantized) -> Dense:
    """The head's HF weight (vocab, hidden) quantized by ``quantized`` as the
    (hidden, vocab) kernel, HEAD_COLUMNS output columns at a time. Both
    quantizers work column by column (int8 per column, int4 per 128-row
    group of a column), so the slices give the whole kernel's codes and
    scales, while the device holds one slice's f32 intermediates instead of
    the whole head's (several GB at 152,064 x 5,120). A vocabulary that is
    not a multiple of 128 does not tile for int4 and is quantized whole (to
    int8)."""
    vocab = weight.shape[0]
    step = HEAD_COLUMNS if vocab % 128 == 0 else vocab
    parts = [quantized(weight[c:c + step].t().contiguous()) for c in range(0, vocab, step)]
    if len(parts) == 1:
        return parts[0]
    fields = ("kernel_q4", "scales4") if parts[0].kernel_q4 is not None else ("kernel_q", "scales")
    return Dense(**{f: torch.cat([getattr(p, f) for p in parts], dim=-1) for f in fields},
                 mesh=parts[0].mesh, tp_kind=parts[0].tp_kind)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().cpu().contiguous()


def _float_kernel(dense: Optional[Dense], what: str) -> torch.Tensor:
    if dense is None or dense.kernel is None:
        raise ValueError(f"save_checkpoint takes unfused float projections; {what} is "
                         "fused or quantized")
    return dense.kernel


def save_checkpoint(model_path: str, cfg: ChatTSConfig, model: ChatTSModel) -> None:
    """Export a model with unfused float projections back to HF layout (one
    ``model.safetensors``, f32, and ``config.json``), the tensor names and
    config the JAX package's ``save_checkpoint`` writes, so checkpoints
    round-trip between the packages.  A tensor-parallel shard raises:
    gather it first (``parallel/sharding.py::gather_model``)."""
    if model.mesh is not None and model.mesh.tp > 1:
        raise ValueError("save_checkpoint writes a whole model, not a tp shard: "
                         "sharding.gather_model gives the whole one")
    os.makedirs(model_path, exist_ok=True)
    tensors: Dict[str, torch.Tensor] = {}
    llm = model.llm
    tensors["model.embed_tokens.weight"] = _f32(llm.embed_tokens)
    tensors["model.norm.weight"] = _f32(llm.norm)
    if llm.lm_head is not None:
        tensors["lm_head.weight"] = _f32(llm.lm_head.t())
    for i, layer in enumerate(llm.layers):
        lp = f"model.layers.{i}."
        tensors[lp + "input_layernorm.weight"] = _f32(layer.input_layernorm)
        tensors[lp + "post_attention_layernorm.weight"] = _f32(layer.post_attention_layernorm)
        attn, mlp = layer.self_attn, layer.mlp
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            d = getattr(attn, proj)
            tensors[lp + f"self_attn.{proj}.weight"] = _f32(_float_kernel(d, lp + proj).t())
            if d.bias is not None:
                tensors[lp + f"self_attn.{proj}.bias"] = _f32(d.bias)
        for norm in ("q_norm", "k_norm"):
            if getattr(attn, norm) is not None:
                tensors[lp + f"self_attn.{norm}.weight"] = _f32(getattr(attn, norm))
        for proj in ("gate_proj", "up_proj", "down_proj"):
            d = getattr(mlp, proj)
            tensors[lp + f"mlp.{proj}.weight"] = _f32(_float_kernel(d, lp + proj).t())
    enc = model.ts_encoder
    for i, (kernel, bias) in enumerate(zip(enc.kernels, enc.biases)):
        tensors[f"ts_encoder.mlp.{2 * i}.weight"] = _f32(kernel.t())
        tensors[f"ts_encoder.mlp.{2 * i}.bias"] = _f32(bias)
    if enc.position_embedding is not None:
        tensors["ts_encoder.position_embedding.weight"] = _f32(enc.position_embedding)

    safetensors_io.save_file(tensors, os.path.join(model_path, safetensors_io.SINGLE_NAME))
    config = {
        "architectures": ["Qwen3TSForCausalLM" if cfg.llm.qk_norm else "Qwen2TSForCausalLM"],
        "model_type": "chatts",
        "vocab_size": cfg.llm.vocab_size,
        "hidden_size": cfg.llm.hidden_size,
        "intermediate_size": cfg.llm.intermediate_size,
        "num_hidden_layers": cfg.llm.num_hidden_layers,
        "num_attention_heads": cfg.llm.num_attention_heads,
        "num_key_value_heads": cfg.llm.num_key_value_heads,
        "head_dim": cfg.llm.head_dim,
        "rms_norm_eps": cfg.llm.rms_norm_eps,
        "rope_theta": cfg.llm.rope_theta,
        "max_position_embeddings": cfg.llm.max_position_embeddings,
        "tie_word_embeddings": cfg.llm.tie_word_embeddings,
        "ts": {
            "patch_size": cfg.ts.patch_size,
            "num_layers": cfg.ts.num_layers,
            "hidden_size": cfg.ts.hidden_size,
            "num_features": cfg.ts.num_features,
            "max_sequence_length": cfg.ts.max_sequence_length,
            "use_position_embedding": cfg.ts.use_position_embedding,
            "use_position_idx": cfg.ts.use_position_idx,
            "embedding_dim": cfg.ts.embedding_dim,
        },
        "ts_token_start_index": cfg.ts_token_start_index,
    }
    with open(os.path.join(model_path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)


@dataclasses.dataclass
class LintReport:
    """Result of :func:`diagnose`: what matched, what's missing (with
    closest-name suggestions), shape mismatches, and what the checkpoint
    contains that the loader would ignore."""

    resolved: Dict[str, str]          # logical key -> physical key
    missing: Tuple[str, ...]          # required logical keys with no match
    unused: Tuple[str, ...]           # physical keys no logical key consumed
    tied_embeddings: bool
    gptq_projections: int             # projections resolved via GPTQ tensors
    # (logical key, expected shape, found shape) for resolved tensors whose
    # checkpoint shape disagrees with the config
    shape_mismatches: Tuple[Tuple[str, Tuple[int, ...], Tuple[int, ...]], ...] = ()
    # missing logical key -> closest checkpoint keys by name similarity
    suggestions: Dict[str, Tuple[str, ...]] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.missing and not self.shape_mismatches

    def summary(self) -> str:
        lines = [
            f"resolved: {len(self.resolved)} tensors"
            + (f" ({self.gptq_projections} GPTQ-packed projections)"
               if self.gptq_projections else ""),
            f"tied embeddings: {self.tied_embeddings}",
        ]
        if self.missing:
            lines.append(f"MISSING ({len(self.missing)}):")
            for k in self.missing:
                hint = ""
                if self.suggestions.get(k):
                    hint = f"   (closest in checkpoint: {', '.join(self.suggestions[k])})"
                lines.append(f"  {k}{hint}")
        if self.shape_mismatches:
            lines.append(f"SHAPE MISMATCHES ({len(self.shape_mismatches)}):")
            lines += [f"  {k}: config expects {exp}, checkpoint has {got}"
                      for k, exp, got in self.shape_mismatches]
        if self.unused:
            lines.append(f"unused checkpoint keys ({len(self.unused)}):")
            lines += [f"  {k}" for k in self.unused]
        if self.ok and not self.unused:
            lines.append("clean: every checkpoint tensor maps to a parameter")
        return "\n".join(lines)


_GPTQ_SUFFIXES = (".qweight", ".qzeros", ".scales", ".g_idx")


def _expected_shapes(cfg: ChatTSConfig) -> Dict[str, Tuple[int, ...]]:
    """Expected HF-layout (out, in) tensor shapes for every logical key,
    derived from the config, so :func:`diagnose` catches a config/checkpoint
    disagreement before any device work.  GPTQ-packed tensors are excluded
    (their shapes depend on pack factor and group size)."""
    lcfg, tcfg = cfg.llm, cfg.ts
    h = lcfg.hidden_size
    qd = lcfg.num_attention_heads * lcfg.head_dim
    kvd = lcfg.num_key_value_heads * lcfg.head_dim
    exp: Dict[str, Tuple[int, ...]] = {
        "model.embed_tokens.weight": (lcfg.vocab_size, h),
        "model.norm.weight": (h,),
        "lm_head.weight": (lcfg.vocab_size, h),
    }
    for i in range(lcfg.num_hidden_layers):
        lp = f"model.layers.{i}."
        exp[lp + "input_layernorm.weight"] = (h,)
        exp[lp + "post_attention_layernorm.weight"] = (h,)
        exp[lp + "self_attn.q_proj.weight"] = (qd, h)
        exp[lp + "self_attn.k_proj.weight"] = (kvd, h)
        exp[lp + "self_attn.v_proj.weight"] = (kvd, h)
        exp[lp + "self_attn.o_proj.weight"] = (h, qd)
        exp[lp + "self_attn.q_proj.bias"] = (qd,)
        exp[lp + "self_attn.k_proj.bias"] = (kvd,)
        exp[lp + "self_attn.v_proj.bias"] = (kvd,)
        exp[lp + "mlp.gate_proj.weight"] = (lcfg.intermediate_size, h)
        exp[lp + "mlp.up_proj.weight"] = (lcfg.intermediate_size, h)
        exp[lp + "mlp.down_proj.weight"] = (h, lcfg.intermediate_size)
        if lcfg.qk_norm:
            exp[lp + "self_attn.q_norm.weight"] = (lcfg.head_dim,)
            exp[lp + "self_attn.k_norm.weight"] = (lcfg.head_dim,)
    # TS patch-MLP input width per position variant (reference:
    # chatts_vllm.py:73-81).
    if tcfg.use_position_embedding:
        in_size = tcfg.patch_size + tcfg.embedding_dim * tcfg.patch_size
        exp["ts_encoder.position_embedding.weight"] = (
            tcfg.max_sequence_length + 1, tcfg.embedding_dim)
    elif tcfg.use_position_idx:
        in_size = 2 * tcfg.patch_size
    else:
        in_size = tcfg.patch_size
    for i in range(tcfg.num_layers):
        exp[f"ts_encoder.mlp.{2 * i}.weight"] = (tcfg.hidden_size, in_size)
        exp[f"ts_encoder.mlp.{2 * i}.bias"] = (tcfg.hidden_size,)
        in_size = tcfg.hidden_size
    return exp


def diagnose(model_path: str, cfg: Optional[ChatTSConfig] = None) -> LintReport:
    """Dry-run the key mapping of :func:`load_checkpoint` without reading any
    tensor data: reports unmatched keys (with closest-name suggestions),
    config-vs-checkpoint shape disagreements (header metadata only), and
    checkpoint keys the loader would ignore.

    Run it before converting a real ChatTS-8B/14B export (reference
    contract: chatts/vllm/chatts_vllm.py:467-470,612-625) to see whether the
    loader understands the checkpoint's naming scheme."""
    if cfg is None:
        cfg = ChatTSConfig.from_pretrained(model_path)
    with LazyStateDict(model_path) as lazy:
        sd = ResolvedStateDict(lazy)
        expected = _expected_shapes(cfg)
        resolved: Dict[str, str] = {}
        missing = []
        shape_mismatches = []
        gptq_projections = 0

        def want(logical: str, required: bool = True, check_shape: bool = True) -> bool:
            actual = sd.resolve(logical)
            if actual is not None:
                resolved[logical] = actual
                sd.used.add(actual)
                exp = expected.get(logical)
                if check_shape and exp is not None:
                    got = lazy.shape(actual)
                    if tuple(got) != tuple(exp):
                        shape_mismatches.append((logical, tuple(exp), tuple(got)))
                return True
            if required:
                missing.append(logical)
            return False

        def want_proj(logical: str, bias: bool):
            nonlocal gptq_projections
            if want(logical + ".weight", required=False):
                pass
            elif any(sd.resolve(logical + s) for s in _GPTQ_SUFFIXES[:3]):
                gptq_projections += 1
                for s in _GPTQ_SUFFIXES:
                    # Packed shapes depend on pack factor and group size: name only.
                    want(logical + s, required=(s != ".g_idx"), check_shape=False)
            else:
                missing.append(logical + ".weight")
            if bias:
                want(logical + ".bias", required=False)

        lcfg = cfg.llm
        want("model.embed_tokens.weight")
        want("model.norm.weight")
        for i in range(lcfg.num_hidden_layers):
            lp = f"model.layers.{i}."
            want(lp + "input_layernorm.weight")
            want(lp + "post_attention_layernorm.weight")
            for proj in ("q_proj", "k_proj", "v_proj"):
                want_proj(lp + "self_attn." + proj, bias=lcfg.attention_bias)
            want_proj(lp + "self_attn.o_proj", bias=False)
            for proj in ("gate_proj", "up_proj", "down_proj"):
                want_proj(lp + "mlp." + proj, bias=False)
            if lcfg.qk_norm:
                want(lp + "self_attn.q_norm.weight")
                want(lp + "self_attn.k_norm.weight")
        tied = not want("lm_head.weight", required=False)
        for i in range(cfg.ts.num_layers):
            want(f"ts_encoder.mlp.{2 * i}.weight")
            want(f"ts_encoder.mlp.{2 * i}.bias")
        if cfg.ts.use_position_embedding:
            want("ts_encoder.position_embedding.weight")

        suggestions: Dict[str, Tuple[str, ...]] = {}
        all_keys = list(sd.keys())
        for k in missing:
            close = difflib.get_close_matches(k, all_keys, n=2, cutoff=0.6)
            if close:
                suggestions[k] = tuple(close)
        unused = tuple(sorted(set(sd.keys()) - sd.used))
    return LintReport(
        resolved=resolved,
        missing=tuple(missing),
        unused=unused,
        tied_embeddings=tied,
        gptq_projections=gptq_projections,
        shape_mismatches=tuple(shape_mismatches),
        suggestions=suggestions,
    )


# The JAX package's older name for diagnose.
lint_checkpoint = diagnose


def load_tokenizer(model_path: str):
    """The checkpoint's tokenizer through ``transformers`` (imported only
    here) when tokenizer files exist, else None."""
    if not any(os.path.exists(os.path.join(model_path, f)) for f in TOKENIZER_FILES):
        return None
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(model_path, trust_remote_code=False)


def from_pretrained(
    model_path: str, *, dtype=torch.bfloat16, device="cuda", mesh=None,
) -> Tuple[ChatTSConfig, ChatTSModel, object]:
    """(config, model, tokenizer) from an HF checkpoint directory; the
    tokenizer is None when the directory has no tokenizer files. With
    ``mesh`` the model is this rank's tensor-parallel shard."""
    cfg, model = load_checkpoint(model_path, dtype=dtype, device=device, mesh=mesh)
    return cfg, model, load_tokenizer(model_path)


def main(argv=None) -> int:
    """The conversion lint: prints :func:`diagnose`'s report; exit 1 unless ok."""
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print("usage: python -m chatts_tpu_torch.models.weights CKPT", file=sys.stderr)
        return 2
    report = diagnose(args[0])
    print(report.summary())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
