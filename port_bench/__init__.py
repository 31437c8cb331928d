"""The benchmark of ``chatts_tpu_torch``, the PyTorch and CUDA port of ChatTS.

One run serves one cell of ``BENCHMARK.json`` (a model configuration under a
traffic mix) through the port's ``ServeEngine`` on one card, measures the
end-to-end metrics over a window of ``--seconds`` (or, with ``--trace 1``,
the per-layer metrics), checks the served tokens against a plain float32
reference, and prints one JSON line:

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, per-layer metric
or decoder architecture is a file of its own, found by the name
``BENCHMARK.json`` or a configuration gives it: ``configs/<config>.json``,
``traffic/<mix>.json``, ``metrics/<metric>.py`` and
``families/<family>.py``.  A family gives what the benchmark knows of one
decoder (``families/__init__.py``): its weights, the port's model built from
them, its plain reference with the control, its FLOPs and its kernels'
bounds; the rest is shared.  The yardstick (traffic generation, the
reduction of rounds and traces to metrics, the peaks and bounds, the
references and the comparison) lives here and imports nothing of JAX or of
the JAX package; the references import nothing of the port either.
"""
