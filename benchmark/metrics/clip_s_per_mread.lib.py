"""Library stage seconds a million reads: the aligner's clip passes of the
defaults over the window, `timings["polish.clip.trim"]` (quality-trim
masks and masked-tail CIGARs), `["polish.clip.semialigned"]` and
`["polish.clip.overlap"]` summed (parts of `polish.clip`), over its reads.
None where the program has none of these spans."""

import harness

SPANS = ("polish.clip.trim", "polish.clip.semialigned", "polish.clip.overlap")


def read(record):
    if record.get("entry") != "library":
        return None
    stage = record["stage_seconds"]
    if not any(k in stage for k in SPANS):
        return None
    return harness.s_per_mread(sum(stage.get(k, 0.0) for k in SPANS),
                               record["reads"])
