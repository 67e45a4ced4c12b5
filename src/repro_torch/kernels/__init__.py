"""Hand-written CUDA kernels (``csrc/``), their wrappers and the planner."""
