"""Library stage seconds a million reads: the aligner's
`timings["fetch.wait"]` (the wait for the card's queued work before the
copies, a part of `fetch`) over the window, over its reads.  None where
the program has no such span."""

import harness


def read(record):
    if record.get("entry") != "library":
        return None
    return harness.s_per_mread(record["stage_seconds"].get("fetch.wait"),
                               record["reads"])
