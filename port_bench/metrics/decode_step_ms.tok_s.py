"""decode_step_ms.tok_s: see BENCHMARK.json for its unit, layer and the metric it moves."""
from port_bench import readers


def read(run):
    return readers.decode_step_ms(run)
