"""Frozen counts of kernels' work and the peaks they are held to."""
