"""vm layer of the plain reference prover."""
