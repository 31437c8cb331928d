"""The benchmark of ``chatts_tpu_torch``, the PyTorch and CUDA port of ChatTS.

One run serves one cell of ``BENCHMARK.json`` (a model configuration under a
traffic mix) through the port's ``ServeEngine`` on one card, measures the
end-to-end metrics over a window of ``--seconds`` (or, with ``--trace 1``,
the per-layer metrics), checks the served tokens against a plain float32
reference, and prints one JSON line:

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer metric
is a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<mix>.json`` and ``metrics/<metric>.py``.
The yardstick (traffic generation, the reduction of rounds and traces to
metrics, the peaks and bounds, the reference and the comparison) lives here
and imports nothing of JAX or of the JAX package; the reference imports
nothing of the port either.
"""
