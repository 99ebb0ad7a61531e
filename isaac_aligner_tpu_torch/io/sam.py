"""SAM record model and text serialization.

The port's own copy of the parts of `isaac_aligner_tpu/io/sam.py` that it
calls, unchanged: the header names the program `isaac_aligner_tpu`, so the
port's SAM bytes equal the reference package's.  Reference analog:
src/c++/include/bam/Bam.hh (serializeAlignment).
"""

from __future__ import annotations

import dataclasses

# SAM flag bits
FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100
FLAG_QC_FAIL = 0x200
FLAG_DUPLICATE = 0x400
FLAG_SUPPLEMENTARY = 0x800


@dataclasses.dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str           # "*" if unmapped
    pos: int             # 1-based leftmost; 0 if unmapped
    mapq: int
    cigar: str           # "*" if unmapped
    rnext: str = "*"
    pnext: int = 0
    tlen: int = 0
    seq: str = "*"
    qual: str = "*"
    tags: dict[str, tuple[str, object]] = dataclasses.field(default_factory=dict)

    def set_tag(self, name: str, typ: str, value: object) -> None:
        self.tags[name] = (typ, value)

    def to_line(self) -> str:
        fields = [
            self.qname, str(self.flag), self.rname, str(self.pos), str(self.mapq),
            self.cigar, self.rnext, str(self.pnext), str(self.tlen), self.seq, self.qual,
        ]
        for name, (typ, value) in sorted(self.tags.items()):
            fields.append(f"{name}:{typ}:{value}")
        return "\t".join(fields)

    @property
    def is_mapped(self) -> bool:
        return not (self.flag & FLAG_UNMAPPED)


def header_lines(contigs, sample: str = "sample", program: str = "isaac_aligner_tpu",
                 version: str = "0.1.0",
                 extra_tags: tuple[str, ...] = (),
                 pu: str | None = None, description: str = "",
                 reference_name: str = "") -> list[str]:
    """@HD/@SQ/@RG/@PG header (reference: bam::serializeHeader,
    src/c++/include/bam/Bam.hh:94).  `extra_tags` carries literal
    additional header lines (reference --bam-header-tag; '\\t' in the
    flag value is already expanded by the CLI).  `pu` fills the RG PU
    field (reference --bam-pu-format, manual.md:281), `description` the
    @PG DS tag (--description, manual.md:366) and `reference_name` an
    @CO REFERENCE line (--reference-name, manual.md:485)."""
    lines = ["@HD\tVN:1.6\tSO:coordinate"]
    for c in contigs:
        lines.append(f"@SQ\tSN:{c.name}\tLN:{c.length}\tM5:{c.md5}")
    rg = f"@RG\tID:0\tSM:{sample}"
    if pu:
        rg += f"\tPU:{pu}"
    lines.append(rg)
    pg = f"@PG\tID:{program}\tPN:{program}\tVN:{version}"
    if description:
        pg += f"\tDS:{description}"
    lines.append(pg)
    if reference_name and reference_name != "default":
        lines.append(f"@CO\tREFERENCE:{reference_name}")
    lines.extend(extra_tags)
    return lines


def write_sam(path, records: list[SamRecord], contigs, **header_kw) -> None:
    with open(path, "w") as f:
        for line in header_lines(contigs, **header_kw):
            f.write(line + "\n")
        for r in records:
            f.write(r.to_line() + "\n")
