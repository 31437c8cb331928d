"""device_gap_pct.tok_s: see BENCHMARK.json for its unit, layer and the metric it moves."""
from port_bench import spans


def read(run):
    return spans.device_gap_pct(run)
