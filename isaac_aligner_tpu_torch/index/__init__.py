"""Sorted k-mer seed index: build, save and load (host, numpy)."""
