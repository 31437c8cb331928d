"""FLOP, byte and bound counts against numbers worked by hand, for both
configurations: the shared bounds (``flops.py``) and the Qwen family's model
FLOPs."""
import json
import os

import pytest

from port_bench import flops
from port_bench.cells import Bench

HERE = os.path.dirname(os.path.abspath(__file__))
QWEN = Bench(os.path.join(HERE, "..", "..")).family("qwen")


def config(name):
    with open(os.path.join(HERE, "..", "configs", name + ".json")) as f:
        return json.load(f)


def test_layer_params():
    # 14B: 5120 x 7168 (q 5120, k and v 1024 each) + 5120 x 5120 + 5120 x 27648 + 13824 x 5120
    assert QWEN.layer_matmul_params(config("chatts-14b-int4")) == 36_700_160 + 26_214_400 \
        + 141_557_760 + 70_778_880
    # Qwen3-8B: 4096 x 6144 + 4096 x 4096 + 4096 x 24576 + 12288 x 4096
    assert QWEN.layer_matmul_params(config("qwen3-8b-ts-int4")) == 25_165_824 + 16_777_216 \
        + 100_663_296 + 50_331_648


def test_int4_bound_decode_and_prefill():
    # R = 32 on the 14B gate/up (5120 x 27648): bytes 70,778,880 + 40 x 27648 x 4 +
    # 2 x 32 x 32768 = 77,299,712 at 3.35 TB/s, above 2 x 32 x 5120 x 27648 operations at 989 T
    assert flops.int4_bound_s(32, 5120, 27648) == pytest.approx(77_299_712 / 3.35e12)
    # R = 4096 on the Qwen3-8B down (12288 x 4096): operations bound
    assert flops.int4_bound_s(4096, 12288, 4096) == pytest.approx(
        2 * 4096 * 12288 * 4096 / 989e12)


def test_flash_bound_and_pairs():
    assert flops.prefix_pairs([3, 4]) == 6 + 10
    assert flops.span_pairs(2, 5) == 3 + 4 + 5
    assert flops.span_pairs(5, 5) == 0
    # one row of 1,024 tokens, Qwen3-8B heads: 4 x 128 x 32 x 524,800 operations
    b = flops.flash_bound_s(32, 8, 128, 1024, 1024, flops.prefix_pairs([1024]))
    assert b == pytest.approx(max(4 * 128 * 32 * 524_800 / 989e12,
                                  2 * 128 * (2 * 1024 * 32 + 2 * 1024 * 8) / 3.35e12))


def test_request_flops():
    cfg = config("chatts-14b-int4")
    layer = 2.0 * QWEN.layer_matmul_params(cfg)
    per_key = 4.0 * 40 * 128
    head = 2.0 * 5120 * 152064
    # a prompt of 10 tokens, then deliveries of 1 and 2 tokens
    got = QWEN.request_flops(cfg, 10, [(1.0, 1), (2.0, 2)])
    prefill = 10 * 48 * layer + 48 * per_key * 55 + head
    # outputs 1 and 2 run at positions 10 and 11, attending 11 and 12 keys
    decode = 2 * (48 * layer + head) + 48 * per_key * (11 + 12)
    assert got[0] == (1.0, pytest.approx(prefill))
    assert got[1] == (2.0, pytest.approx(decode))
