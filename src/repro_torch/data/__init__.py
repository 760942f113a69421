"""Synthetic data for the port's entry points."""
