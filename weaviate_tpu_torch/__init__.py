"""PyTorch/CUDA port of ``weaviate_tpu``, written for one NVIDIA H100.

The package mirrors the JAX package's module paths (``ops/distance.py`` here
is the counterpart of ``weaviate_tpu/ops/distance.py``, and so on) and is
held against it by the ``tests/test_torch_*.py`` parity tests. It imports
``torch``, ``numpy`` and ``msgpack`` only, never ``jax`` nor any module of
``weaviate_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no device asked for they raise. Every Pallas kernel of the JAX
package becomes a hand-written Hopper kernel under ``csrc/``, built on first
use by ``_build.py``.
"""
