"""deeplearning4j_tpu_torch: the PyTorch/CUDA port of deeplearning4j_tpu
for NVIDIA Hopper (H100, sm_90a).

The JAX package beside it is the reference. This package imports `torch`
and never `jax` or anything of `deeplearning4j_tpu`; it keeps its own copy
of what it needs. Every TPU kernel on a ported path is a kernel written by
hand for Hopper (`kernels/csrc/`), built at first use. Entry points run on
the card unless the caller passes `device="cpu"`, where each kernel's plain
PyTorch version runs instead.

The port serves `models.zoo.transformer_lm` over HTTP with paged-KV
continuous batching (`serving.InferenceServer`) and trains it with
`nn.graph.ComputationGraph.fit`; it trains word, document and vertex
embeddings (`nlp/`, `graph/`) with PyTorch ops on the card, where the JAX
package has no Pallas kernel.
"""

__version__ = "0.1.0"
