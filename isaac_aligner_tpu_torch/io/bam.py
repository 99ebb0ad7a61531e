"""CIGAR parsing.

The port's own copy of `parse_cigar` from `isaac_aligner_tpu/io/bam.py`,
unchanged.  BAM writing comes with the workflow.
"""

from __future__ import annotations


def parse_cigar(cigar: str) -> list[tuple[int, str]]:
    out = []
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            out.append((int(num), ch))
            num = ""
    return out
