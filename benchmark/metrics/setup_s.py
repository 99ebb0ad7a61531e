"""Seconds of set-up: genome, index (loaded, or built on a checkout's
first run), library, the program's set-up and the warm-up job or batches
(host clock)."""


def read(record):
    return record.get("setup_s")
