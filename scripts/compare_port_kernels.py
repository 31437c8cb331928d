#!/usr/bin/env python3
"""Times the port's int8-activation matmul (B5) and int8 decode attention
(B4) from one tree of the repository, on the card, so that two commits can
be compared inside one process-per-tree run on one card.

    python3 scripts/compare_port_kernels.py <tree> [<tree> ...]

Each ``<tree>`` is a directory holding a ``chatts_tpu_torch`` package (the
working tree is ``.``; another commit is unpacked with ``git archive <commit>
chatts_tpu_torch | tar -x -C <dir>``).  With several trees the script runs
itself once per tree, in the order given (parent, change, change, parent
shows the drift of the card beside the difference), because one process can
load only one ``chatts_tpu_torch``.  Timing is ``chip_smoke.py``'s
(``graph_ms``: CUDA-graph replay between CUDA events, inputs rotated through
more than the L2 cache holds for B4, four weight sets for B5).

B5: the four ChatTS-14B layer projections at R = 1, 37, 64, 640, 4096 and
5120 rows, each checked against ``int4_matmul_a8_reference`` (share of
outputs equal to the bit), and their sums by R.  B4: 24 slots, 40 heads over
8, capacities 1024 and 6144 with random lengths, and capacity 1024 with 16
slots live at 540 to 585 keys and 8 empty (a serving decode round of
``chip_smoke.py`` phase 5).
"""
from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
A8_SHAPES = {"qkv": (5120, 7168), "o": (5120, 5120), "gate_up": (5120, 27648),
             "down": (13824, 5120)}
A8_ROWS = (1, 37, 64, 640, 4096, 5120)


def chip_smoke():
    """``chip_smoke.py`` of this script's repository, for its timing helpers."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_tree(root: str) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import chatts_tpu_torch
    from chatts_tpu_torch.ops import int4_matmul as i4
    from chatts_tpu_torch.ops import ragged_decode_attention as rda

    if not os.path.abspath(chatts_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"chatts_tpu_torch was loaded from {chatts_tpu_torch.__file__}, "
                           f"not from {root}")
    smoke = chip_smoke()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"tree {root} on {smoke.nvidia_smi_line()}", flush=True)
    sums = {}
    for name, (in_dim, out_dim) in A8_SHAPES.items():
        weights = [smoke._int4_weights(torch, gen, dev, in_dim, out_dim) for _ in range(4)]
        for r in A8_ROWS:
            x_q = torch.randint(-127, 128, (r, in_dim), generator=gen, device=dev,
                                dtype=torch.int8)
            x_scale = (torch.rand((r,), generator=gen, device=dev) + 0.5) / 127
            ref = i4.int4_matmul_a8_reference(x_q, x_scale, *weights[0])
            got = i4.int4_matmul_a8(x_q, x_scale, *weights[0])
            torch.cuda.synchronize()
            equal = float((got == ref).float().mean())
            turn = [0]

            def run(x_q=x_q, x_scale=x_scale):
                turn[0] = (turn[0] + 1) % len(weights)
                i4.int4_matmul_a8(x_q, x_scale, *weights[turn[0]])

            ms = smoke.graph_ms(run)
            sums[r] = sums.get(r, 0.0) + ms
            print(f"  int4_matmul_a8 {name} R={r}: {ms:.4f} ms "
                  f"{2 * r * in_dim * out_dim / ms / 1e9:.0f} TOP/s, bit-equal {equal:.4%}",
                  flush=True)
        del weights
    print("  int4_matmul_a8, a layer's four projections, ms by R: "
          + ", ".join(f"{r}: {ms:.4f}" for r, ms in sums.items()), flush=True)
    b, h, kvh, d = 24, 40, 8, 128
    for cap, lens in ((1024, None), (1024, [540 + 3 * i for i in range(16)] + [0] * 8),
                      (6144, None)):
        lengths = (torch.randint(0, cap + 1, (b,), generator=gen, device=dev).to(torch.int32)
                   if lens is None else torch.tensor(lens, dtype=torch.int32, device=dev))

        def make(_):
            return (torch.randint(-127, 128, (b, kvh, cap, d), generator=gen, device=dev,
                                  dtype=torch.int8),
                    torch.randint(-127, 128, (b, kvh, cap, d), generator=gen, device=dev,
                                  dtype=torch.int8),
                    (torch.rand((b, kvh, cap), generator=gen, device=dev) + 0.5) / 127,
                    (torch.rand((b, kvh, cap), generator=gen, device=dev) + 0.5) / 127)

        caches = smoke.rotating(make, 2 * b * kvh * cap * (d + 4))
        q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
        turn = [0]

        def run8():
            turn[0] = (turn[0] + 1) % len(caches)
            rda.ragged_decode_attention_int8(q, *caches[turn[0]], lengths)

        print(f"  ragged_decode_attention_int8 B={b} H={h} KVH={kvh} S={cap}, "
              f"{int((lengths > 0).sum())} rows live, mean length "
              f"{float(lengths.float().mean()):.0f}: {smoke.graph_ms(run8):.4f} ms", flush=True)
        del caches


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    if len(argv) == 1:
        run_tree(argv[0])
        return 0
    for tree in argv:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), tree],
                            timeout=600).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
