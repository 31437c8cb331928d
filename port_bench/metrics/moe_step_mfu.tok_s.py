"""moe_step_mfu.tok_s: see BENCHMARK.json for its unit, layer and the metric it moves."""
from port_bench import readers


def read(run):
    return readers.mfu_pct(run)
