"""Reads a second through the paired aligner library: all reads of the
window's batches over all their time, each batch's results on the host
(host clock)."""


def read(record):
    if record.get("entry") != "library" or not record.get("window_s"):
        return None
    return record["reads"] / record["window_s"]
