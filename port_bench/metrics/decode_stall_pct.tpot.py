"""decode_stall_pct.tpot: see BENCHMARK.json for its unit, layer and the metric it moves."""
from port_bench import readers


def read(run):
    return readers.decode_stall_pct(run)
