"""expert_load_skew.tok_s: see BENCHMARK.json for its unit, layer and the metric it moves.
The family's reduction of the port's expert counter (``families/moonlight.py``)."""


def read(run):
    return getattr(run.family, "expert_load_skew", lambda _: None)(run)
