"""elasticdl_tpu_torch — the PyTorch/CUDA port of elasticdl_tpu.

The JAX package (``elasticdl_tpu``) stays the reference.  This package
imports neither it nor JAX: it keeps its own copy of everything it needs,
runs its hot path through CUDA kernels written for Hopper
(``ops/csrc/``), and runs on the CUDA card unless a caller passes
``device="cpu"`` (where every kernel wrapper uses its plain PyTorch
version).

What is ported so far: serving DeepFM (artifact loading in
``serving.export``, the micro-batcher ``serving.batcher``, the hot-swap
replica ``serving.runtime``); training DeepFM in PS mode
(``parallel.ps_trainer`` over ``layers.embedding`` and
``ops.sparse_embedding``); training the causal transformer LM on one
card (``parallel.dp_trainer`` and ``zoo.transformer_lm`` over
``ops.flash_attention``) and context-parallel over a ``parallel.mesh``;
the sharded dispatch of the sparse ops over a mesh, which the PS trainer
and serving take; the block-gather probe ``ops.sparse_gather`` with
its experiment script ``bench.exp_sparse_gather``; and checkpoints in
the JAX package's layout (``checkpoint``: plain, sharded and the delta
chain, which the serving replica applies); the preprocessing layers
(``preprocessing``) and the CTR zoo they feed (census, wide_and_deep),
and the supervised fleet of replica processes (``serving.supervisor``).
"""

__version__ = "0.1.0"
