"""PyTorch/CUDA port of ``repro`` (HAM on an NVIDIA H100).

The package mirrors ``repro``'s module paths one for one; ``repro`` stays the
reference the port is tested against.  It imports ``torch`` and never
``jax`` or ``repro``.  Subpackages are imported on demand: ``core`` (errors,
device handler table), ``models`` (dense GQA and MoE decoders, xLSTM),
``kernels`` (hand-written CUDA kernels for attention, the grouped matmul
and the chunkwise mLSTM, with their plain versions), ``serve``
(continuous-batching engine), ``configs`` (architecture configs).
"""

__version__ = "0.1.0"
