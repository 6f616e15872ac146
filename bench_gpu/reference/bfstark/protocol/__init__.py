"""protocol layer of the plain reference prover."""
