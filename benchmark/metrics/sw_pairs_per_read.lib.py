"""(query, window) pairs sent to the banded SW kernel a read: the
aligner's `sw_pairs` counter over the window, over its reads."""


def read(record):
    if record.get("entry") != "library" or not record.get("reads"):
        return None
    return record["sw_pairs"] / record["reads"]
