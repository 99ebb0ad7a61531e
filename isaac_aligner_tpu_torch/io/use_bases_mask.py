"""--use-bases-mask grammar: per-cycle use/skip/index designation.

The port's own copy of `isaac_aligner_tpu/io/use_bases_mask.py`, unchanged.

Reference analog: options::UseBasesMaskGrammar
(src/c++/include/options/UseBasesMaskGrammar.hh, tested by
lib/options/cppunit/testUseBasesMaskGrammar.cpp) and the mask expansion in
lib/options/alignOptions/UseBasesMaskOption.cpp.

Syntax: comma-separated entries, one per RunInfo <Read> segment, each a
sequence of groups `y|n|i` followed by an optional repeat count or `*`:

    y101,i8,y101        use 101 data cycles, 8 index cycles, 101 data
    y100n,i6n,y100n     skip the last cycle of each segment
    y*,i*,y*            wildcard: fill the segment's remaining cycles

At most one `*` per entry; it expands to the segment's leftover cycle
count.  The expanded entry must exactly cover the segment's NumCycles.
"""

from __future__ import annotations

import re

from .bcl import RunInfo

_GROUP = re.compile(r"([ynYNiI])(\*|\d*)")


def parse_entry(entry: str, num_cycles: int) -> str:
    """One mask entry -> an expanded string of 'y'/'n'/'i', len num_cycles."""
    groups: list[tuple[str, int | None]] = []  # (flag, count or None for '*')
    pos = 0
    star_at = None
    fixed = 0
    for m in _GROUP.finditer(entry):
        if m.start() != pos:
            raise ValueError(f"use-bases-mask: bad syntax at {entry[pos:]!r}")
        pos = m.end()
        flag = m.group(1).lower()
        count_s = m.group(2)
        if count_s == "*":
            if star_at is not None:
                raise ValueError(f"use-bases-mask: two '*' in entry {entry!r}")
            star_at = len(groups)
            groups.append((flag, None))
        else:
            n = int(count_s) if count_s else 1
            fixed += n
            groups.append((flag, n))
    if pos != len(entry):
        raise ValueError(f"use-bases-mask: bad syntax at {entry[pos:]!r}")
    if star_at is None:
        if fixed != num_cycles:
            raise ValueError(
                f"use-bases-mask entry {entry!r} covers {fixed} cycles, "
                f"read has {num_cycles}")
    else:
        if fixed > num_cycles:
            raise ValueError(
                f"use-bases-mask entry {entry!r} exceeds {num_cycles} cycles")
        groups[star_at] = (groups[star_at][0], num_cycles - fixed)
    return "".join(flag * n for flag, n in groups)  # type: ignore[operator]


def parse_use_bases_mask(mask: str, cycles_per_read: list[int]) -> list[str]:
    """Full mask -> per-read expanded flag strings."""
    entries = mask.split(",")
    if len(entries) != len(cycles_per_read):
        raise ValueError(
            f"use-bases-mask {mask!r} has {len(entries)} entries, run has "
            f"{len(cycles_per_read)} reads")
    return [parse_entry(e, n) for e, n in zip(entries, cycles_per_read)]


def effective_segments(info: RunInfo, mask: str | None = None
                       ) -> list[tuple[bool, list[int]]]:
    """(is_indexed, 0-based global cycle list) per effective segment.

    Without a mask, segments mirror RunInfo (all cycles used).  With a
    mask, each RunInfo read contributes its 'y' cycles as a data segment
    and its 'i' cycles as an index segment; 'n' cycles are dropped.
    Segments with no surviving cycles vanish (e.g. `n8` turns an index
    read off entirely).
    """
    if mask is None:
        return [(seg.is_indexed, list(range(first - 1, last)))
                for seg, first, last in info.cycle_ranges()]
    expanded = parse_use_bases_mask(mask, [r.num_cycles for r in info.reads])
    out: list[tuple[bool, list[int]]] = []
    for (seg, first, _last), flags in zip(info.cycle_ranges(), expanded):
        data = [first - 1 + i for i, f in enumerate(flags) if f == "y"]
        index = [first - 1 + i for i, f in enumerate(flags) if f == "i"]
        if data:
            out.append((False, data))
        if index:
            out.append((True, index))
    if not any(not ix for ix, _ in out):
        raise ValueError(f"use-bases-mask {mask!r} leaves no data cycles")
    return out
