"""Lattice layout, Philox, observables, Metropolis and the engine registry."""
