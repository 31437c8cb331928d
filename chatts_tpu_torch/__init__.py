"""ChatTS on PyTorch and CUDA: the port of ``chatts_tpu`` to an NVIDIA H100.

The JAX package ``chatts_tpu`` stays the reference.  This package mirrors its
layout (``core/``, ``processor/``, ``models/``, ``ops/``, ``runtime/``,
``serve/``), imports ``torch`` and never ``jax``, and imports nothing of the
JAX package: it keeps its own copies of the numpy-only host layers
(``core/config.py``, ``core/encoding.py``, ``processor/processor.py``,
``utils/native.py``, ``utils/profiling.py``).  Every Pallas kernel on its path
is a CUDA kernel written for Hopper (``csrc/``), built by ``kernels/build.py``.
"""

__version__ = "0.1.0"
