"""decode_step_device_ms.tok_s: see BENCHMARK.json for its unit, layer and the metric it moves."""
from port_bench import spans


def read(run):
    return spans.decode_step_device_ms(run)
