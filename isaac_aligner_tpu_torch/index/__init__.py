"""Sorted k-mer seed index: build, save and load, neighbor annotation,
contig groups and index tools."""
