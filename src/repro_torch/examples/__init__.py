"""The JAX package's examples on the port (``examples/`` there),
each ``python -m repro_torch.examples.<name> [--device cpu]``:

* ``quickstart``        -- one ``RunSpec`` + ``Session`` an engine against
  Onsager, the spec round trip, and the raw per-half-sweep multispin
  kernel (``kernels.multispin.run_sweeps_multispin``);
* ``phase_transition``  -- the Fig. 5/6 validation scan, one ensemble-mode
  spec a lattice size;
* ``bitplane_replicas`` -- 32 replicas from one simulation: replica
  averaging above T_c, coalescence below it;
* ``multipod_sim``      -- the per-half-sweep distributed step on a 2 x 2
  mesh, bit for bit the single-device ``run_sweeps_philox``;
* ``train_lm``          -- the LM stack's training loop
  (``launch.train`` on internlm2-1.8b's smoke config, 60 steps, with
  checkpoints and restore).

They run on the CUDA card unless ``--device cpu`` is given, at the JAX
scripts' sizes and settings.  In the four Ising examples a fresh lattice
is the port's own Philox draw and the acceptance table its own
(``ROADMAP.md`` Queue 3), so the printed values agree with the JAX
scripts' in their physics, not digit for digit.
"""
