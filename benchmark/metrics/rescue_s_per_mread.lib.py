"""Library stage seconds a million reads: the aligner's
`timings["polish.rescue"]` (shadow and disjoined rescue, its launches and
fetches included, a part of `polish`) over the window, over its reads.
None where the program has no such span."""

import harness


def read(record):
    if record.get("entry") != "library":
        return None
    return harness.s_per_mread(record["stage_seconds"].get("polish.rescue"),
                               record["reads"])
