"""Library stage seconds a million reads: the multi-index aligner's
`timings["merge"]` (the host merge of the contig groups' results) over
the window, over its reads.  None on one index, or where the program has
no such span."""

import harness


def read(record):
    if record.get("entry") != "library":
        return None
    return harness.s_per_mread(record["stage_seconds"].get("merge"),
                               record["reads"])
