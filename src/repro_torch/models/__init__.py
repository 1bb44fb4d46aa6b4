"""LM models of the port: layers, the dense transformer, weight interop."""
