"""PyTorch/CUDA port of ``repro`` (HAM on an NVIDIA H100).

The package mirrors ``repro``'s module paths one for one; ``repro`` stays the
reference the port is tested against.  It imports ``torch`` and never
``jax`` or ``repro``.  Subpackages are imported on demand: ``core`` (errors,
device handler table, and the HAM wire layer: flags, messages, migratable
values, wire plans, the handler registry, closures, futures, executors),
``comm`` (the in-process fabric), ``offload`` (node runtime, offload
domain, buffer data plane), ``cluster`` (worker pool, scheduler, session
router), ``models`` (dense GQA and MoE decoders, xLSTM, Mamba2/Zamba2),
``kernels`` (hand-written CUDA kernels for attention, the grouped matmul,
the chunkwise mLSTM and the SSD scan, with their plain versions), ``serve``
(continuous-batching engine, cluster serving through the HAM runtime,
worker decode loops), ``configs`` (architecture configs).
"""

__version__ = "0.1.0"
