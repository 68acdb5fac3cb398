"""Hand-written Hopper kernels (``csrc/*.cu``), each with its plain
PyTorch version beside its wrapper."""
