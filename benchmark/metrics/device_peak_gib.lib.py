"""Peak device memory (GiB) of the library window:
torch.cuda.max_memory_allocated after a reset before the window."""


def read(record):
    if record.get("entry") != "library" or "device_peak_bytes" not in record:
        return None
    return record["device_peak_bytes"] / 2**30
