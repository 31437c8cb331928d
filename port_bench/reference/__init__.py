"""The plain reference the benchmark holds the port's served tokens to.

Plain PyTorch and NumPy, float32 with TF32 off, written from the published
description of ChatTS (a decoder, an MLP patch encoder for the series, patch
embeddings merged at the ``<ts>`` placeholders) and of its processor's sp
encoding.  This package holds what every family shares: the processor and
the pieces of the forward pass; each decoder family's own layers are its
``logits`` (``families/<family>.py``).  None of it imports JAX, the JAX
package or ``chatts_tpu_torch``, and it takes only what the benchmark made:
the prompts, the series and the weights a family drew.
"""
