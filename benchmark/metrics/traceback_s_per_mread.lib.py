"""Library stage seconds a million reads: the aligner's
`timings["polish.gapped.traceback"]` (the host traceback, rescoring and
acceptance of every banded SW pair) over the window, over its reads.
None where the program has no such span."""

import harness


def read(record):
    if record.get("entry") != "library":
        return None
    return harness.s_per_mread(
        record["stage_seconds"].get("polish.gapped.traceback"),
        record["reads"])
