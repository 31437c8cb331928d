"""The fixture's Qwen family: the benchmark's own (``port_bench/families/qwen.py``)."""
from port_bench.families.qwen import (  # noqa: F401
    KERNELS, logits, make, mixed_launches, port_model, request_flops, spies)
