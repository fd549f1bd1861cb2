"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), each with its plain
PyTorch version and launch counter beside it.  Modules build their kernel at
first use (``_build``), never at import."""
