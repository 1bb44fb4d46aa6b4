"""Batched graph-analytics serving for the port."""
