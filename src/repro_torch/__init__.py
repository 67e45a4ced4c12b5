"""repro_torch: the PyTorch and CUDA port of the ``repro`` Ising study.

A second package beside the JAX reference (``repro``), with the same
layout where that helps a reader find a module's counterpart.  Its entry
points (``repro_torch.api.Session``, ``python -m repro_torch run``) run
on the CUDA card unless the caller asks for ``device="cpu"``; on the CPU
every kernel wrapper takes its plain PyTorch version.  It imports
neither ``jax`` nor anything of ``repro``.
"""
