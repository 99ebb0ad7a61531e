"""FASTQ->BAM reads a second: all reads of the window's workflow jobs
over all their time (host clock)."""


def read(record):
    if record.get("entry") != "workflow" or not record.get("window_s"):
        return None
    return record["reads"] / record["window_s"]
