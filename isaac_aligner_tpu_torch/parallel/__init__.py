"""Multi-index (contig-group) alignment across several indexes."""
