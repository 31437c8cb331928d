"""The plain reference the benchmark holds the port's served tokens to.

Plain PyTorch and NumPy, float32 with TF32 off, written from the published
description of ChatTS (a Qwen2 or Qwen3 decoder, an MLP patch encoder for the
series, patch embeddings merged at the ``<ts>`` placeholders) and of its
processor's sp encoding.  It imports nothing of JAX, of the JAX package or of
``chatts_tpu_torch``, and takes only what the benchmark made: the prompts,
the series and the weights of ``port_bench/weights.py``.
"""
