"""zero_tig_torch: the PyTorch/CUDA port of the JAX package (`zero_tig_tpu/`) for an NVIDIA H100.

Streaming inference (``pipeline.steps.predict_step`` / ``predict_chunk``)
with hand-written CUDA kernels under ``csrc/`` for the fused convolutions
(K1), the RAFT update core (K2) and the uint8 equalise (K3). Imports torch,
never jax. Entry points run on the CUDA card unless a caller passes
``device="cpu"``, where each kernel's plain PyTorch twin runs instead.
"""
