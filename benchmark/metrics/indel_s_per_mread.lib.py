"""Library stage seconds a million reads: the aligner's
`timings["polish.indel"]` (the simple-indel aligner, and the pair fields
worked out again after it moves an end, `polish.indel.repair`; a part of
`polish`) over the window, over its reads.  None where the program has no
such span."""

import harness


def read(record):
    if record.get("entry") != "library":
        return None
    return harness.s_per_mread(record["stage_seconds"].get("polish.indel"),
                               record["reads"])
