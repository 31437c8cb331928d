"""A family that only this fixture has: the Qwen family with its head tied to
the embedding table, which the Qwen family's reference does not compute.
The port's ``QwenModel`` with no int4 head and ``tie_word_embeddings``
multiplies the final norm's output by the embedding's transpose in float32;
the reference does the same over the Qwen family's final hidden states."""
import torch

from port_bench.families import qwen
from port_bench.families.qwen import (  # noqa: F401
    KERNELS, make, mixed_launches, request_flops, spies)
from port_bench.reference.model import full_f32


def port_model(cfg, w):
    pcfg, model = qwen.port_model(cfg, w)
    model.llm.lm_head_q = None
    return pcfg, model


@torch.no_grad()
def logits(cfg, w, seqs, lowered=False):
    hidden = qwen.final_hidden(cfg, w, seqs, lowered)
    with full_f32():
        head = w["embed"].float().t()
        return [x @ head for x in hidden]
