"""moe_int4.roofline_pct.tok_s: see BENCHMARK.json for its unit, layer and the metric it moves."""
from port_bench import readers


def read(run):
    return readers.roofline_pct(run, "moe_int4")
