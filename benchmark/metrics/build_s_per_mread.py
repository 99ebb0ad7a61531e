"""Build seconds a million reads: the window's jobs' summed
`build_seconds` (Stats/BuildStats.json: sort, duplicate marking, gap
realignment, BAM, .bai, .md5) over their reads."""

import harness


def read(record):
    if record.get("entry") != "workflow":
        return None
    return harness.s_per_mread(record.get("build_seconds"), record["reads"])
