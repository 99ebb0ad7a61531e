"""FASTA/FASTQ reading and SAM writing (host, numpy)."""
