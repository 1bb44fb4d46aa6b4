"""Synthetic relational catalogs for the port."""
