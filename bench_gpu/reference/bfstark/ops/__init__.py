"""ops layer of the plain reference prover."""
