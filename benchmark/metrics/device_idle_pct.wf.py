"""Share (%) of the traced window in which no kernel, copy or set ran on
the card (torch.profiler, one more whole job)."""


def read(record):
    prof = record.get("profile")
    if record.get("entry") != "workflow" or not prof or not prof["window_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
