"""Batched serving for the port: LM decode and graph analytics."""
