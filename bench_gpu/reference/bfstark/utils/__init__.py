"""utils layer of the plain reference prover."""
