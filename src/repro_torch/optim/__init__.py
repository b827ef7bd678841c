"""Optimizers applied at the PS."""
