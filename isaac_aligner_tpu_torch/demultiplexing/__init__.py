"""Demultiplexing: sample sheets and barcode resolution.

The port's own copy of `isaac_aligner_tpu/demultiplexing`, unchanged.  The
output process imports these modules: they import numpy, never torch.

Reference analog: src/c++/lib/demultiplexing (SampleSheetCsv,
BarcodeLoader/BarcodeResolver, DemultiplexingStats).
"""

from .samplesheet import BarcodeSpec, parse_sample_sheet  # noqa: F401
from .resolver import resolve_barcodes  # noqa: F401
