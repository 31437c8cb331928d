"""Megatron tensor parallelism for the port's ChatTS model, caches and batches.

Counterpart of ``chatts_tpu/parallel/sharding.py``, which states the layout
as PartitionSpecs and lets GSPMD move the data (replacing the reference's
delegation to vLLM's tensor_parallel_size, reference: README.md:127,
chatts/utils/llm_utils.py:95,154).  The spec tables below are its tables,
with a spec a tuple of axis names (``P(None, MODEL_AXIS)`` is
``(None, "tp")``): q/k/v column-sharded and o row-sharded, gate/up
column-sharded and down row-sharded, one sum over tp a sublayer; the
embedding and the head vocab-parallel.

The port has no GSPMD, so ``place_params`` cuts each rank's tensors and the
model runs the collectives itself (``models/qwen.py``).  Where its layout
differs from JAX's, it is because a rank must compute whole units:

- ``sanitize_spec`` replicates a tensor whose dim tp does not divide, one
  tensor at a time, and GSPMD reshards around it.  The port decides a unit
  at a time: the attention block (q, k, v, o) shards only when tp divides
  the heads and the kv heads (and an int4 o_proj's groups), else it is
  replicated whole, and so are the MLP (tp must divide the intermediate
  size, and an int4 down_proj's groups) and the vocabulary (embedding and
  head together).  A replicated unit runs whole on every rank, with no
  collective.  JAX would shard k and v of 2 kv heads over tp = 4 by columns
  (16 columns of 2 heads of 8 divide by 4), splitting heads.
- The TS encoder is replicated: JAX shards its last layer's output columns
  (``ts_encoder_param_specs``), which the merge then gathers; it is small
  beside the decoder.
- A fused qkv_proj or gate_up_proj is cut part by part (each rank's q, k
  and v columns, then concatenated), so a rank's fused product splits as a
  whole one does.
- An activation-order row projection keeps this rank's part of ``perm4``
  (JAX replicates it): the rank gathers its input over tp and picks its
  rows' columns.

``shard_dim`` reads the tables for both cuts: ``place_params`` cuts a
loaded model's fields by it, and the sharded load
(``models/weights.py::load_checkpoint(mesh=)``) the checkpoint's tensors;
the two give the same tensors, to the bit.  ``init_params(mesh=)``
(``models/qwen.py``) draws a random model's tensors in the single-device
order and cuts each layer as it is drawn (``shard_layer``), so no rank
holds the whole model.

Training on a mesh (``train/``) reads ``grad_kinds``: a sharded tensor's
gradient is this rank's own, a replicated one's is whole on every rank,
except the Qwen3 q/k norms of a sharded attention block, applied to this
rank's heads only, whose gradients are partial and summed over tp.
``local_train_batch`` gives a dp group its rows of a training batch;
``gather_model`` puts a float shard back together for export.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from chatts_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh


def P(*axes) -> Tuple:
    """A partition spec: one mesh axis (or None) a dimension."""
    return tuple(axes)


def _col_specs() -> Dict[str, Any]:
    return {
        "kernel": P(None, MODEL_AXIS), "bias": P(MODEL_AXIS),
        "kernel_q": P(None, MODEL_AXIS), "scales": P(MODEL_AXIS),
        "kernel_q4": P(None, MODEL_AXIS), "scales4": P(None, MODEL_AXIS),
        "zeros4": P(None, MODEL_AXIS), "perm4": P(),
    }


def _row_specs() -> Dict[str, Any]:
    return {
        "kernel": P(MODEL_AXIS, None),
        "kernel_q": P(MODEL_AXIS, None), "scales": P(),
        "kernel_q4": P(MODEL_AXIS, None), "scales4": P(MODEL_AXIS, None),
        "zeros4": P(MODEL_AXIS, None), "perm4": P(),
    }


def _attn_specs() -> Dict[str, Any]:
    col = _col_specs()
    return {"q_proj": col, "k_proj": col, "v_proj": col, "o_proj": _row_specs(),
            "q_norm": P(), "k_norm": P()}


def _mlp_specs() -> Dict[str, Any]:
    col = _col_specs()
    return {"gate_proj": col, "up_proj": col, "down_proj": _row_specs()}


def layer_specs() -> Dict[str, Any]:
    return {"input_layernorm": P(), "post_attention_layernorm": P(),
            "self_attn": _attn_specs(), "mlp": _mlp_specs()}


def llm_param_specs(num_layers: int) -> Dict[str, Any]:
    return {
        "embed_tokens": P(MODEL_AXIS, None),
        "layers": [layer_specs() for _ in range(num_layers)],
        "norm": P(),
        "lm_head": P(None, MODEL_AXIS),
        "lm_head_q": _col_specs(),
    }


def ts_encoder_param_specs(num_layers: int) -> Dict[str, Any]:
    """JAX's table; the port replicates the encoder (module docstring)."""
    return {
        "mlp": [
            {"kernel": P(None, MODEL_AXIS) if i == num_layers - 1 else P(),
             "bias": P(MODEL_AXIS) if i == num_layers - 1 else P()}
            for i in range(num_layers)
        ],
        "position_embedding": P(),
    }


def chatts_param_specs(cfg) -> Dict[str, Any]:
    return {"ts_encoder": ts_encoder_param_specs(cfg.ts.num_layers),
            "llm": llm_param_specs(cfg.llm.num_hidden_layers)}


def kv_cache_specs(num_layers: int) -> List[Tuple[Tuple, Tuple]]:
    """(B, KVH, S, D) head-major: rows over dp, kv heads over tp."""
    spec = P(DATA_AXIS, MODEL_AXIS, None, None)
    return [(spec, spec) for _ in range(num_layers)]


def batch_specs() -> Dict[str, Tuple]:
    """A ProcessedBatch's arrays: rows over dp; the series and the scatter
    tables replicated (they cross-reference rows)."""
    return {"input_ids": P(DATA_AXIS), "positions": P(DATA_AXIS), "seq_lens": P(DATA_AXIS),
            "ts_values": P(), "ts_mask": P(), "scatter_seq": P(), "scatter_tok": P()}


def sanitize_spec(spec: Sequence, shape: Sequence[int], mesh) -> Tuple:
    """Drop mesh axes that do not divide the corresponding dim (JAX's rule;
    ``mesh`` needs only ``shape``)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, entries):
        if axis is None:
            out.append(None)
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        out.append(axis if dim % size == 0 else None)
    return P(*out)


# ---------------------------------------------------------------------------
# The port's units: which parts a mesh shards, and each rank's range.
# ---------------------------------------------------------------------------

def split_range(n: int, index: int, count: int) -> Tuple[int, int]:
    """Part ``index``'s [start, stop) of n split evenly into ``count``."""
    if n % count:
        raise ValueError(f"{n} does not split evenly into {count}")
    part = n // count
    return index * part, (index + 1) * part


def shard_range(n: int, mesh: Mesh) -> Tuple[int, int]:
    """This rank's [start, stop) of n split evenly over tp."""
    return split_range(n, mesh.tp_index, mesh.tp)


DENSE_FIELDS = ("kernel", "kernel_q4", "scales4", "zeros4", "perm4", "kernel_q", "scales",
                "bias")


def dense_specs(kind: str) -> Dict[str, Any]:
    """The port's layout of a ``Dense``'s fields for ``kind``: JAX's column
    and row tables, but a row shard keeps its part of ``perm4`` (module
    docstring).  A field a table leaves out (a row layer's bias) is whole."""
    if kind == "col":
        return _col_specs()
    if kind == "row":
        return {**_row_specs(), "perm4": P(MODEL_AXIS)}
    raise ValueError(f"kind is 'col' or 'row', not {kind!r}")


def shard_dim(kind: str, field: str) -> Optional[int]:
    """The dimension of a ``Dense`` field that a ``kind`` shard splits over
    tp, None where the shard holds it whole.  ``place_params`` cuts a loaded
    ``Dense`` by it, and the sharded load cuts the checkpoint's tensors by
    it (an HF weight is the kernel transposed; GPTQ's qweight, scales and
    zero-points lie as kernel_q4, scales4 and zeros4)."""
    spec = dense_specs(kind).get(field, P())
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def attention_sharded(lcfg, mesh: Optional[Mesh], o_groups: Optional[int] = None) -> bool:
    """Whether the attention block shards over tp: tp divides the heads and
    the kv heads, and an int4 o_proj's ``o_groups``."""
    if mesh is None or mesh.tp == 1:
        return False
    tp = mesh.tp
    return (lcfg.num_attention_heads % tp == 0 and lcfg.num_key_value_heads % tp == 0
            and (o_groups is None or o_groups % tp == 0))


def mlp_sharded(lcfg, mesh: Optional[Mesh], down_groups: Optional[int] = None) -> bool:
    """Whether the MLP shards over tp: tp divides the intermediate size and
    an int4 down_proj's ``down_groups``."""
    if mesh is None or mesh.tp == 1:
        return False
    return (lcfg.intermediate_size % mesh.tp == 0
            and (down_groups is None or down_groups % mesh.tp == 0))


def vocab_sharded(lcfg, mesh: Optional[Mesh]) -> bool:
    """Whether the embedding and the head shard their vocabulary over tp."""
    return mesh is not None and mesh.tp > 1 and lcfg.vocab_size % mesh.tp == 0


def column_index(parts: Sequence[int], mesh: Mesh) -> np.ndarray:
    """The columns of a column-parallel projection this rank holds: its
    share of each of ``parts`` (a fused projection's q | k | v, or one
    part), in order."""
    cols, offset = [], 0
    for p in parts:
        start, stop = shard_range(p, mesh)
        cols.append(np.arange(offset + start, offset + stop))
        offset += p
    return np.concatenate(cols)


def _copy(t: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    return None if t is None else t.to(device, copy=True).contiguous()


def _cut(t: Optional[torch.Tensor], dim: Optional[int], mesh: Mesh, parts: Sequence[int],
         device) -> Optional[torch.Tensor]:
    """This rank's share of ``t`` along ``dim`` (of each of ``parts``, the
    whole dim by default), or all of it for ``dim`` None, on ``device``."""
    if t is None or dim is None:
        return _copy(t, device)
    index = torch.as_tensor(column_index(parts or [t.shape[dim]], mesh), device=t.device)
    return t.index_select(dim, index).to(device).contiguous()


def shard_dense(dense, mesh: Mesh, kind: str, parts: Optional[Sequence[int]] = None,
                device=None):
    """This rank's shard of a ``Dense``, each field cut where ``shard_dim``
    says: ``kind`` "col" (its columns of each of ``parts``, the whole
    output by default) or "row" (its input rows and their groups)."""
    from chatts_tpu_torch.models.qwen import Dense

    device = device if device is not None else dense._weight.device
    parts = list(parts or []) if kind == "col" else []
    return Dense(**{name: _cut(getattr(dense, name), shard_dim(kind, name), mesh, parts, device)
                    for name in DENSE_FIELDS}, mesh=mesh, tp_kind=kind)


def copy_dense(dense, device, mesh: Optional[Mesh] = None):
    """A replicated ``Dense``: the whole layer, copied to ``device``, on
    ``mesh`` (so that it runs as JAX's layers under a mesh do)."""
    from chatts_tpu_torch.models.qwen import Dense

    return Dense(**{name: _copy(getattr(dense, name), device) for name in DENSE_FIELDS},
                 mesh=mesh)


def _int4_groups(dense) -> Optional[int]:
    return None if dense.scales4 is None else dense.scales4.shape[0]


def check_kernel_shapes(model, device) -> None:
    """On the card, every sharded int4 projection must tile for B3 at its
    per-rank shape (``ops/int4_matmul.py::supported_tp``); raises otherwise,
    so no shard reaches a kernel that refuses it."""
    from chatts_tpu_torch.models.qwen import Dense
    from chatts_tpu_torch.ops import int4_matmul as i4

    if torch.device(device).type != "cuda":
        return
    for name, module in model.named_modules():
        if isinstance(module, Dense) and module.tp_kind and module.kernel_q4 is not None:
            tp = module.mesh.tp
            in_dim, out_dim = module.in_features, module.out_features
            if module.tp_kind == "col":
                out_dim *= tp
            else:
                in_dim *= tp
            if not i4.supported_tp(module.mesh, in_dim, out_dim, i4.DEFAULT_GROUP,
                                   module.tp_kind):
                raise ValueError(f"{name}: a {module.tp_kind} shard of ({in_dim}, {out_dim}) "
                                 f"over tp {tp} does not tile for int4_matmul")


def shard_layer(layer, lcfg, mesh: Mesh, device):
    """This rank's ``DecoderLayer`` of a whole one: the attention block and
    the MLP each sharded where tp divides them, else copied whole."""
    from chatts_tpu_torch.models.qwen import MLP, Attention, DecoderLayer

    attn, mlp = layer.self_attn, layer.mlp
    h, kvh, d = lcfg.num_attention_heads, lcfg.num_key_value_heads, lcfg.head_dim
    norms = {"q_norm": _copy(attn.q_norm, device), "k_norm": _copy(attn.k_norm, device)}
    if attention_sharded(lcfg, mesh, _int4_groups(attn.o_proj)):
        if attn.qkv_proj is not None:
            projs = {"qkv_proj": shard_dense(attn.qkv_proj, mesh, "col",
                                             [h * d, kvh * d, kvh * d], device)}
        else:
            projs = {n: shard_dense(getattr(attn, n), mesh, "col", device=device)
                     for n in ("q_proj", "k_proj", "v_proj")}
        new_attn = Attention(lcfg, shard_dense(attn.o_proj, mesh, "row", device=device),
                             **projs, **norms, num_heads=h // mesh.tp,
                             num_kv_heads=kvh // mesh.tp, mesh=mesh)
    else:
        projs = {n: copy_dense(getattr(attn, n), device, mesh)
                 for n in ("qkv_proj", "q_proj", "k_proj", "v_proj") if getattr(attn, n) is not None}
        new_attn = Attention(lcfg, copy_dense(attn.o_proj, device, mesh), **projs, **norms)
    inter = lcfg.intermediate_size
    if mlp_sharded(lcfg, mesh, _int4_groups(mlp.down_proj)):
        if mlp.gate_up_proj is not None:
            ups = {"gate_up_proj": shard_dense(mlp.gate_up_proj, mesh, "col", [inter, inter],
                                               device)}
        else:
            ups = {n: shard_dense(getattr(mlp, n), mesh, "col", device=device)
                   for n in ("gate_proj", "up_proj")}
        new_mlp = MLP(shard_dense(mlp.down_proj, mesh, "row", device=device), **ups)
    else:
        ups = {n: copy_dense(getattr(mlp, n), device, mesh)
               for n in ("gate_up_proj", "gate_proj", "up_proj") if getattr(mlp, n) is not None}
        new_mlp = MLP(copy_dense(mlp.down_proj, device, mesh), **ups)
    return DecoderLayer(lcfg, new_attn, new_mlp, _copy(layer.input_layernorm, device),
                        _copy(layer.post_attention_layernorm, device))


def place_params(mesh: Optional[Mesh], cfg, model_or_jax_params: Union[Any, Mapping[str, Any]],
                 device=None):
    """This rank's ``ChatTSModel`` of a whole model on ``mesh``: local head
    counts, sharded projections, the vocabulary split where tp divides it,
    everything copied to ``device`` (the model's own by default; the card
    for JAX parameters given as numpy, ``from_jax_params``' input).  The
    whole model is left as it was.  Without a mesh the model is returned
    on ``device``."""
    from chatts_tpu_torch.models.chatts import ChatTSModel
    from chatts_tpu_torch.models.convert import from_jax_params
    from chatts_tpu_torch.models.ts_encoder import TSEncoder

    if isinstance(model_or_jax_params, ChatTSModel):
        model = model_or_jax_params
        device = torch.device(device) if device is not None else model.llm.norm.device
    else:
        device = torch.device(device if device is not None else "cuda")
        model = from_jax_params(model_or_jax_params, cfg, "cpu")
    if mesh is None:
        return model.to(device)
    if mesh.tp > 1 and model.mesh is not None:
        raise ValueError("place_params takes a whole model, not a shard")
    with torch.no_grad():
        layers = [shard_layer(layer, cfg.llm, mesh, device) for layer in model.llm.layers]
        new_llm = place_vocab(mesh, cfg.llm, model.llm, layers, device)
        encoder = TSEncoder(cfg.ts, device=device)
        encoder.load_state_dict(model.ts_encoder.state_dict())
    out = ChatTSModel(cfg, encoder, new_llm)
    check_kernel_shapes(out, device)
    return out


@torch.no_grad()
def place_vocab(mesh: Mesh, lcfg, llm, layers: Sequence, device):
    """The ``QwenModel`` on ``mesh`` of the rank's ``layers`` (already
    placed) and of the whole ``llm``'s embedding, final norm and head, the
    vocabulary cut where tp divides it."""
    from chatts_tpu_torch.models.qwen import QwenModel

    vocab_start = None
    embed, lm_head = _copy(llm.embed_tokens, device), _copy(llm.lm_head, device)
    lm_head_q = None if llm.lm_head_q is None else copy_dense(llm.lm_head_q, device, mesh)
    if vocab_sharded(lcfg, mesh):
        vocab_start = shard_range(lcfg.vocab_size, mesh)[0]
        embed = _cut(llm.embed_tokens, 0, mesh, [], device)
        lm_head = _cut(llm.lm_head, 1, mesh, [], device)
        if llm.lm_head_q is not None:
            lm_head_q = shard_dense(llm.lm_head_q, mesh, "col", device=device)
    return QwenModel(lcfg, embed, layers, _copy(llm.norm, device), lm_head=lm_head,
                     lm_head_q=lm_head_q, mesh=mesh, vocab_start=vocab_start)


def grad_kinds(model) -> Dict[int, str]:
    """How the gradient of each of the model's parameters lies on its mesh,
    by ``id``: "sharded" (this rank's part of a tensor cut over tp; its
    gradient is the rank's own), "partial" (a whole tensor whose gradient
    each rank computes only a part of, summed over tp: the Qwen3 q/k norms
    of a sharded attention block) or "whole" (every other: replicated, its
    gradient whole on every rank).  A tensor missing from the map is whole."""
    from chatts_tpu_torch.models.qwen import Attention, Dense, QwenModel

    kinds: Dict[int, str] = {}
    for module in model.modules():
        if isinstance(module, Dense) and module.tp_kind:
            for name in ("kernel", "bias"):
                t = getattr(module, name)
                if t is not None:
                    kinds[id(t)] = ("sharded" if shard_dim(module.tp_kind, name) is not None
                                    else "whole")
        elif isinstance(module, Attention) and module.mesh is not None:
            for t in (module.q_norm, module.k_norm):
                if t is not None:
                    kinds[id(t)] = "partial"
        elif isinstance(module, QwenModel) and module.vocab_start is not None:
            for t in (module.embed_tokens, module.lm_head):
                if t is not None:
                    kinds[id(t)] = "sharded"
    return kinds


def local_train_batch(batch: Mapping[str, Any], mesh: Optional[Mesh]) -> Dict[str, Any]:
    """A training batch's rows for this rank's dp group (``dp_rows``): the
    row tensors cut, the series whole, the scatter table pointed at the
    local rows (patches of other rows out of bounds, which the merge
    drops), as ``local_batch`` does for a ``ProcessedBatch``."""
    b = batch["input_ids"].shape[0]
    r0, r1 = dp_rows(mesh, b)
    if (r0, r1) == (0, b):
        return dict(batch)
    out = {k: (v[r0:r1] if k in TRAIN_ROW_KEYS else v) for k, v in batch.items()}
    seq = batch.get("scatter_seq")
    if seq is not None:
        seq = seq.long()
        seq = torch.where(seq < 0, seq + b, seq) - r0
        out["scatter_seq"] = torch.where((seq >= 0) & (seq < r1 - r0), seq,
                                         r1 - r0).to(batch["scatter_seq"].dtype)
    return out


TRAIN_ROW_KEYS = ("input_ids", "positions", "attention_mask", "targets", "loss_mask")


def _whole_dense(dense, parts: Sequence[int], device):
    """The whole float ``Dense`` of a shard (every rank of the tp group
    calls it): each cut field gathered over tp, its columns put back in
    the whole layer's order (``column_index`` of each rank)."""
    from chatts_tpu_torch.models.qwen import Dense
    from chatts_tpu_torch.parallel.mesh import all_gather_tp

    if dense.kernel is None:
        raise ValueError("gather_model takes float projections")
    mesh, kind = dense.mesh, dense.tp_kind
    fields = {}
    for name in ("kernel", "bias"):
        t = getattr(dense, name)
        dim = shard_dim(kind, name) if kind else None
        if t is None or dim is None:
            fields[name] = _copy(t, device)
            continue
        gathered = all_gather_tp(mesh, t.detach(), dim=dim).to(device)
        n = gathered.shape[dim] // mesh.tp
        whole = torch.empty_like(gathered)
        cols = list(parts) if kind == "col" and parts else [gathered.shape[dim]]
        for r in range(mesh.tp):
            rank = dataclasses.replace(mesh, tp_index=r)
            index = torch.as_tensor(column_index(cols, rank), device=device)
            whole.index_copy_(dim, index, gathered.narrow(dim, r * n, n))
        fields[name] = whole
    return Dense(fields["kernel"], bias=fields["bias"])


@torch.no_grad()
def gather_model(model, device="cpu"):
    """The whole float ``ChatTSModel`` of a shard, on ``device``: a
    collective over the tp group, which every rank of it calls; a model
    with no mesh is returned as it is.  Quantized projections raise."""
    from chatts_tpu_torch.models.chatts import ChatTSModel
    from chatts_tpu_torch.models.qwen import MLP, Attention, DecoderLayer, QwenModel
    from chatts_tpu_torch.models.ts_encoder import TSEncoder
    from chatts_tpu_torch.parallel.mesh import all_gather_tp

    mesh, llm, cfg = model.mesh, model.llm, model.cfg
    if mesh is None:
        return model
    lcfg = cfg.llm
    h, kvh, d, inter = (lcfg.num_attention_heads, lcfg.num_key_value_heads, lcfg.head_dim,
                        lcfg.intermediate_size)
    layers = []
    for layer in llm.layers:
        attn, mlp = layer.self_attn, layer.mlp
        norms = {n: _copy(getattr(attn, n), device) for n in ("q_norm", "k_norm")}
        if attn.qkv_proj is not None:
            projs = {"qkv_proj": _whole_dense(attn.qkv_proj, [h * d, kvh * d, kvh * d], device)}
        else:
            projs = {n: _whole_dense(getattr(attn, n), [], device)
                     for n in ("q_proj", "k_proj", "v_proj")}
        if mlp.gate_up_proj is not None:
            ups = {"gate_up_proj": _whole_dense(mlp.gate_up_proj, [inter, inter], device)}
        else:
            ups = {n: _whole_dense(getattr(mlp, n), [], device) for n in ("gate_proj", "up_proj")}
        layers.append(DecoderLayer(
            lcfg, Attention(lcfg, _whole_dense(attn.o_proj, [], device), **projs, **norms),
            MLP(_whole_dense(mlp.down_proj, [], device), **ups),
            _copy(layer.input_layernorm, device), _copy(layer.post_attention_layernorm, device)))
    vocab = llm.vocab_start is not None
    if llm.lm_head_q is not None:
        raise ValueError("gather_model takes a float head")

    def whole_vocab(t, dim):
        if t is None:
            return None
        return all_gather_tp(mesh, t.detach(), dim=dim).to(device) if vocab else _copy(t, device)

    new_llm = QwenModel(lcfg, whole_vocab(llm.embed_tokens, 0), layers, _copy(llm.norm, device),
                        lm_head=whole_vocab(llm.lm_head, 1))
    encoder = TSEncoder(cfg.ts, device=device)
    encoder.load_state_dict(model.ts_encoder.state_dict())
    return ChatTSModel(cfg, encoder, new_llm)


def infer_mesh(model) -> Optional[Mesh]:
    """The mesh a model was placed on, or None for a single-device model."""
    llm = getattr(model, "llm", model)
    return getattr(llm, "mesh", None)


def dp_rows(mesh: Optional[Mesh], b: int) -> Tuple[int, int]:
    """This rank's dp group's rows [start, stop) of a batch of b rows
    (``batch_specs``: rows over dp, in dp order)."""
    if mesh is None or mesh.dp == 1:
        return 0, b
    if b % mesh.dp:
        raise ValueError(f"a batch of {b} rows does not split over dp {mesh.dp}")
    part = b // mesh.dp
    return mesh.dp_index * part, (mesh.dp_index + 1) * part


def local_batch(batch, mesh: Optional[Mesh]):
    """The ProcessedBatch of this rank's dp group: its rows of the row
    arrays; the series whole, as ``batch_specs`` replicates them, with the
    scatter table pointed at the local rows (patches of other rows out of
    bounds, so the merge drops them)."""
    b = batch.input_ids.shape[0]
    r0, r1 = dp_rows(mesh, b)
    if (r0, r1) == (0, b):
        return batch
    seq = batch.scatter_seq.astype(np.int64)
    seq = np.where(seq < 0, seq + b, seq) - r0
    seq = np.where((seq >= 0) & (seq < r1 - r0), seq, r1 - r0).astype(batch.scatter_seq.dtype)
    rows = slice(r0, r1)
    return dataclasses.replace(
        batch, input_ids=batch.input_ids[rows], attention_mask=batch.attention_mask[rows],
        positions=batch.positions[rows], seq_lens=batch.seq_lens[rows], scatter_seq=seq,
        encoded_prompts=batch.encoded_prompts[rows], ts_metas=batch.ts_metas[rows])
