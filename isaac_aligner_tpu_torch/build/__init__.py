"""Output pipeline: columnar records, genomic bins, coordinate sort,
duplicate marking, known-gap realignment (host, numpy).

Reference analog: src/c++/lib/build (Build / BinSorter /
DuplicatePairEndFilter / GapRealigner / BamSerializer).
"""
