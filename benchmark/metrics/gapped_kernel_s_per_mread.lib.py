"""Library stage seconds a million reads: the aligner's
`timings["polish.gapped.kernel"]` (the upload of the gapped polish's
queries and windows, the banded SW launch and the copy back of its
scores and traceback) over the window, over its reads.  None where the
program has no such span."""

import harness


def read(record):
    if record.get("entry") != "library":
        return None
    return harness.s_per_mread(
        record["stage_seconds"].get("polish.gapped.kernel"), record["reads"])
