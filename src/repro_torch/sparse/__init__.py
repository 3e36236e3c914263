"""Synthetic sparse matrices (SuiteSparse-like families)."""
