"""Share (%) of the banded SW kernel's roofline: the least time its
traced launches could take (operations over the card's float32 lane rate
or bytes over its HBM rate, whichever is longer, from each launch's
shape; `roofline.banded_sw_counts`) over the profiler's summed time of
the kernel in the same trace.  None without launches or a known card."""

import program
import roofline


def read(record):
    prof = record.get("profile")
    if record.get("entry") != "library" or not prof:
        return None
    secs = sum(v for k, v in prof["op_seconds"].items()
               if program.SW_KERNEL in k)
    pct, _bound = roofline.roofline_pct(record.get("sw_launches"), secs,
                                        roofline.PEAKS.get(record.get("card")))
    return pct
