"""Decoder families: what the benchmark knows of one architecture.

A configuration's file names its family (``"family": "qwen"``), and
``cells.Bench.family`` loads ``families/<family>.py`` by path from the
benchmark's folder, as it loads a metric's reader.  Adding an architecture
adds a family file beside the configuration, and edits no file the benchmark
has.  A family module gives:

- ``make(cfg, seed, device)``: its weights, a dict of tensors drawn from the
  seed on the device (``weights.Draws``);
- ``port_model(cfg, w)``: the port's ``ChatTSConfig`` and ``ChatTSModel``
  holding those tensors, built through the port's public constructors;
- ``engine_kwargs(cfg)``, only where the ``ServeEngine``'s keyword arguments
  differ from ``harness.engine_kwargs``'s mapping of the file's ``engine``;
- ``logits(cfg, w, seqs, lowered=False)``: the plain float32 reference's
  logits at each ``reference.model.Sequence_``'s wanted positions, and with
  ``lowered=True`` the control, the same a precision below the configuration's;
  it imports nothing of the port;
- ``request_flops(cfg, prompt, puts)``: the model FLOPs of each delivery of
  a request's tokens, (time, FLOPs) a delivery;
- for the traced run (``trace.Tracer``): ``KERNELS``, each roofline key and
  the names its device kernels contain; ``spies(tracer)``, the port's Python
  entry points to wrap, (owner, attribute, wrapper) each, a wrapper giving
  each launch's bound function and its arguments to ``tracer.launch`` (a
  graph replay counts it at its capture's shapes) or, for eager calls alone,
  ``tracer.eager`` (None where the bound cannot be worked out); and
  ``mixed_launches(cfg, engine)``, the
  (key, calls, bound) of the scan-sliced round about to run whose shapes its
  capture cannot give.
"""
