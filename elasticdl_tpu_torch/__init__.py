"""elasticdl_tpu_torch — the PyTorch/CUDA port of elasticdl_tpu.

The JAX package (``elasticdl_tpu``) stays the reference.  This package
imports neither it nor JAX: it keeps its own copy of everything it needs,
runs its hot path through CUDA kernels written for Hopper
(``ops/csrc/``), and runs on the CUDA card unless a caller passes
``device="cpu"`` (where every kernel wrapper uses its plain PyTorch
version).

What is ported so far is the serving path of the DeepFM flagship model:
artifact loading (``serving.export``), the micro-batcher
(``serving.batcher``), the hot-swap replica (``serving.runtime``), the
DeepFM forward (``zoo.deepfm``) and its embedding lookups
(``layers.embedding`` over ``ops.sparse_embedding``).
"""

__version__ = "0.1.0"
