"""The draws every family's weights are made of: random int4 projections,
norms and the TS encoder, made on the device from the run's seed.

A family (``families/<name>.py``) says which tensors its decoder has and
draws them, in its own order, through one ``Draws``; this module says how
each kind is drawn and laid out.  The weights are made in the layout they are
served in, a few large calls a kind (every layer's tensor of one kind in one
call), as plain tensors in a dict: int4 projections as packed bytes (IN/2,
OUT) int8, byte row i holding logical row 2i in its low nibble and 2i + 1 in
its high one, with float32 scales (IN/128, OUT), one per group of 128 input
rows; norms, biases and the embedding table in bfloat16; the TS encoder in
float32.  The same tensors go to the family's reference (which unpacks them
with ``reference/model.py``'s own code) and, through the port's public
constructors, to the port.

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
- the output projections into the residual stream are scaled by 1 / sqrt(2
  layers), as GPT-2 initialises them.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

GROUP = 128


class Draws:
    """One generator seeded from the run's seed on ``device``, and the kinds
    of tensor drawn from it.  ``layers`` is the decoder's depth, which
    scales the residual projections."""

    def __init__(self, seed: int, device, layers: int):
        self.g = torch.Generator(device=device).manual_seed((int(seed) * 1_000_003) % (1 << 63))
        self.device = device
        self.layers = layers

    def packed(self, layers: int, fan_in: int, fan_out: int) -> torch.Tensor:
        """Bytes of two codes uniform over [-7, 7]: k uniform over the 225
        pairs, low code c = k % 15 - 7 and high code k // 15 - 7, each
        stored as its nibble c & 15 = (c + 7 + 9) & 15.  About 1 GiB of
        bytes a call, to bound the temporaries.  ``layers`` 0: one tensor,
        not stacked."""
        shape = (fan_in // 2, fan_out)
        out = torch.empty((max(layers, 1),) + shape, dtype=torch.uint8, device=self.device)
        step = max(1, (1 << 30) // (shape[0] * shape[1]))
        for i in range(0, out.shape[0], step):
            k = torch.randint(0, 225, out[i:i + step].shape, generator=self.g,
                              device=self.device, dtype=torch.uint8)
            lo = (k % 15 + 9) & 15
            out[i:i + step] = lo | (((k // 15 + 9) & 15) << 4)
        out = out.view(torch.int8)
        return out if layers else out[0]

    def scales(self, layers: int, fan_in: int, fan_out: int,
               residual: bool = False) -> torch.Tensor:
        """Group scales of ``packed``'s codes.  Codes have standard
        deviation 4.3; a scale of about 1 / (7 sqrt(fan_in)) keeps a
        projection's output near its input's size."""
        shape = (layers, fan_in // GROUP, fan_out) if layers else (fan_in // GROUP, fan_out)
        u = torch.rand(shape, generator=self.g, device=self.device)
        s = (0.5 + u) / (7.0 * math.sqrt(fan_in))
        return s / math.sqrt(2 * self.layers) if residual else s

    def around_one(self, *shape) -> torch.Tensor:
        """bfloat16 uniform over [0.5, 1.5): norm weights."""
        return (0.5 + torch.rand(shape, generator=self.g, device=self.device)).to(torch.bfloat16)

    def ts_encoder(self, ts: dict) -> Dict[str, torch.Tensor]:
        """ChatTS's patch encoder (``ts`` a configuration's ``ts``), float32:
        ``ts.<i>.kernel`` N(0, 1) / sqrt(fan_in), ``ts.<i>.bias`` 0.02 N(0, 1)."""
        w: Dict[str, torch.Tensor] = {}
        sizes = [ts["patch_size"]] + [ts["hidden_size"]] * ts["num_layers"]
        for i in range(ts["num_layers"]):
            w[f"ts.{i}.kernel"] = (torch.randn((sizes[i], sizes[i + 1]), generator=self.g,
                                               device=self.device) / math.sqrt(sizes[i]))
            w[f"ts.{i}.bias"] = 0.02 * torch.randn((sizes[i + 1],), generator=self.g,
                                                   device=self.device)
        return w


def port_ts_encoder(ts_cfg, w: Dict[str, torch.Tensor], device):
    """The port's ``TSEncoder`` (``ts_cfg`` its ``TSEncoderConfig``) holding
    ``Draws.ts_encoder``'s tensors."""
    from chatts_tpu_torch.models.ts_encoder import TSEncoder

    encoder = TSEncoder(ts_cfg, device=device)
    with torch.no_grad():
        for i in range(ts_cfg.num_layers):
            encoder.kernels[i].copy_(w[f"ts.{i}.kernel"])
            encoder.biases[i].copy_(w[f"ts.{i}.bias"])
    return encoder
