"""Workflow stage seconds a million reads: the window's jobs' summed
`stage_seconds.parse` (Stats/MatchSelectorStats.json) over their reads."""

import harness


def read(record):
    if record.get("entry") != "workflow":
        return None
    return harness.s_per_mread(record["stage_seconds"].get("parse"),
                               record["reads"])
