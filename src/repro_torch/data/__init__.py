"""Synthetic corpora (numpy, host side)."""
