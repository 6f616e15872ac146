"""models layer of the plain reference prover."""
