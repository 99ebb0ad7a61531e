"""Library stage seconds a million reads: the aligner's
`timings["fetch"]` over the window, over its reads."""

import harness


def read(record):
    if record.get("entry") != "library":
        return None
    return harness.s_per_mread(record["stage_seconds"].get("fetch"),
                               record["reads"])
