"""Sample sheet parsing.

The port's own copy of `isaac_aligner_tpu/demultiplexing/samplesheet.py`,
unchanged.

Reference analog: demultiplexing::SampleSheetCsv
(src/c++/include/demultiplexing/SampleSheetCsv.hh, CsvGrammar.hh).
Supports the simple CSV layout: header row with at least
`barcode` (dash-separated components allowed, as in dual-index
"ACGTACGT-TTGCAAGG"), `sample`, and optional `project`/`lane` columns.
The reference's special barcode values are honored: "none"/"NoIndex"
means a single unindexed sample; "unknown"/"undetermined" rows name the
fallback bin (reference BarcodeMetadata::isUnknown*, flowcell/
BarcodeMetadata.hh).
"""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path

UNKNOWN_SAMPLE = "unknown"
NO_INDEX = "none"


@dataclasses.dataclass(frozen=True)
class BarcodeSpec:
    index: int
    barcode: str          # "ACGT-TTGC" components joined by '-', or "none"
    sample: str
    project: str = "default"
    lane: int = 1
    # per-barcode reference index/FASTA ("" = the run's -r reference;
    # "unmapped" = do not align, emit unmapped records) — reference
    # BarcodeMetadata reference-index routing
    # (flowcell/BarcodeMetadata.hh:134-136)
    reference: str = ""
    # per-barcode adapter list, '+'-separated ("" = the run's --adapters)
    # (BarcodeMetadata.hh:63-66)
    adapter: str = ""

    @property
    def is_unmapped_reference(self) -> bool:
        return self.reference.strip().lower() == "unmapped"

    @property
    def adapters(self) -> tuple[str, ...]:
        a = self.adapter.strip()
        return tuple(x for x in a.split("+") if x) if a else ()

    @property
    def components(self) -> tuple[str, ...]:
        if self.barcode.lower() in (NO_INDEX, "noindex", ""):
            return ()
        return tuple(self.barcode.upper().split("-"))

    @property
    def is_no_index(self) -> bool:
        return not self.components


def parse_sample_sheet(path: str | Path) -> list[BarcodeSpec]:
    rows: list[BarcodeSpec] = []
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None:
            raise ValueError(f"{path}: empty sample sheet")
        cols = {c.lower().strip(): c for c in reader.fieldnames}
        if "barcode" not in cols or "sample" not in cols:
            raise ValueError(
                f"{path}: sample sheet needs 'barcode' and 'sample' columns, "
                f"got {reader.fieldnames}")
        for i, row in enumerate(reader):
            rows.append(BarcodeSpec(
                index=i,
                barcode=row[cols["barcode"]].strip(),
                sample=row[cols["sample"]].strip(),
                project=(row[cols["project"]].strip()
                         if "project" in cols and row[cols["project"]] else "default"),
                lane=(int(row[cols["lane"]]) if "lane" in cols and row[cols["lane"]]
                      else 1),
                reference=(row[cols["reference"]].strip()
                           if "reference" in cols and row[cols["reference"]]
                           else ""),
                adapter=(row[cols["adapter"]].strip()
                         if "adapter" in cols and row[cols["adapter"]]
                         else ""),
            ))
    if not rows:
        raise ValueError(f"{path}: no barcode rows")
    return rows
