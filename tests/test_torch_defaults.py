"""The port's paired aligner at `isaac-align`'s defaults (Q25 trim,
semialigned and overlap clips, the simple-indel aligner) against the plain
reference of those passes, `benchmark/reference/clips.py`, on the CPU.

Seeded synthetic pairs on a 20 kbp genome: forward-reverse pairs of both
models with NovaSeq-style falling qualities (so the trim reaches many
ends), short inserts (overlapping ends), trimmed ends with a short indel,
a read 2 whose simple-indel alignment lies away from its mate's, and a
disjoined pair whose rescue moves read 1.  For every aligned end the
reference starts from the port's answer with its soft clips aligned again
(`clips.unclipped`) and must give back POS, CIGAR and NM; for every pair
the proper flag and TLEN.  Then the passes' spans and counters, on one
contig group and on two.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from isaac_aligner_tpu_torch import aligner as port_aligner
from isaac_aligner_tpu_torch import dna
from isaac_aligner_tpu_torch.aligner import PairedAligner
from isaac_aligner_tpu_torch.align.pairs import TlsStatic
from isaac_aligner_tpu_torch.index.build import build_index
from isaac_aligner_tpu_torch.io.fasta import genome_from_sequences
from isaac_aligner_tpu_torch.io.fastq import ReadBatch
from isaac_aligner_tpu_torch.parallel.multi_index import \
    MultiIndexPairedAligner



def _bench_reference(name: str):
    """A module of the benchmark's plain references (numpy only)."""
    spec = importlib.util.spec_from_file_location(
        f"bench_reference_{name}",
        Path(__file__).resolve().parents[1] / "benchmark" / "reference"
        / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


clips = _bench_reference("clips")
bamfile = _bench_reference("bamfile")

L = 100
TLS = dict(min=150, max=450, mate_min=150, mate_max=450, best0=1, best1=6,
           median=280)
REF_TLS = {"min": TLS["min"], "max": TLS["max"], "best": (1, 6)}
#: planted places on the 20 kbp genome (forward strand)
X_AT, Y_AT, Y_GAP = 4_000, 15_000, 30    # simple-indel: copy X, source Y
A_AT, A2_AT = 9_000, 18_500              # disjoined: truth A, copy A'


def _rc(r: np.ndarray) -> np.ndarray:
    return dna.revcomp(np.asarray(r, np.uint8))


def _genome_codes() -> np.ndarray:
    rng = np.random.default_rng(1501)
    g = rng.integers(0, 4, 20_000).astype(np.uint8)
    # read 2 of the simple-indel pair, forward: its source Y carries 30
    # bases more after its 50th base; X, near its mate, copies it with 12
    # substitutions past column 40 (the seeds of columns 0-35 still hit)
    fwd2 = g[Y_AT:Y_AT + 50].tolist() + \
        g[Y_AT + 50 + Y_GAP:Y_AT + 100 + Y_GAP].tolist()
    x = np.array(fwd2, np.uint8)
    for j in range(41, 100, 5):
        x[j] = (x[j] + 1) % 4
    g[X_AT:X_AT + L] = x
    # read 1 of the disjoined pair: its truth A with three substitutions
    # (at 10, 40 and 70: no seed hits A); the copy A' holds the read as
    # sequenced but for its columns 1 and 3
    read = g[A_AT:A_AT + L].copy()
    for j in (10, 40, 70):
        read[j] = (read[j] + 1) % 4
    copy = read.copy()
    for j in (1, 3):
        copy[j] = (copy[j] + 2) % 4
    g[A2_AT:A2_AT + L] = copy
    return g


def _quals(rng, n_low: int) -> np.ndarray:
    """NovaSeq-style bins falling toward the 3' end, and `n_low` bases of
    Q2 closing the read."""
    p37 = np.linspace(0.95, 0.6, L)
    u = rng.random(L)
    q = np.where(u < p37, 37, np.where(u < p37 + (1 - p37) * 0.6, 23, 12))
    if n_low:
        q[L - n_low:] = 2
    return q.astype(np.uint8)


def _mutate(rng, r, frac=0.01):
    r = r.copy()
    m = rng.random(r.shape) < frac
    r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
    return r


def _pairs(g: np.ndarray):
    """(rows of (read 1, read 2, quals 1, quals 2), planted row indices)."""
    rng = np.random.default_rng(1502)
    rows = []

    def frag(s, ins, r1_fwd=True, low=(0, 0), r1=None, r2=None,
             quals=None):
        f1 = g[s:s + L] if r1 is None else r1
        f2 = _rc(g[s + ins - L:s + ins]) if r2 is None else r2
        a, b = (f1, f2) if r1_fwd else (f2, f1)
        if quals is None:
            quals = (_quals(rng, low[0]), _quals(rng, low[1]))
            a, b = _mutate(rng, a), _mutate(rng, b)
        rows.append((a, b, *quals))
        return len(rows) - 1

    def flat(q, n_low=0):
        out = np.full(L, q, np.uint8)
        out[L - n_low:] = 2
        return out

    for k in range(40):
        s = int(rng.integers(200, 19_000 - 500))
        while abs(s - X_AT) < 700 or abs(s - A_AT) < 700 or \
                abs(s - Y_AT) < 700 or abs(s - A2_AT) < 700:
            s = int(rng.integers(200, 19_000 - 500))
        ins = int(np.clip(rng.normal(260, 50), 160, 420))
        low = tuple(int(rng.integers(8, 30)) if rng.random() < 0.4 else 0
                    for _ in range(2))
        frag(s, ins, r1_fwd=k % 2 == 0, low=low)
    planted = {}
    # overlapping pairs whose reverse read (the lower qualities) is
    # trimmed or semialigned-clipped on its left first
    for k, s in enumerate((1_200, 2_600, 6_100, 11_300)):
        ins = 150 + 7 * k
        r2 = _rc(g[s + ins - L:s + ins]).copy()
        if k == 3:   # two substitutions at the reverse read's 3' end
            r2[-2] = (r2[-2] + 1) % 4
            r2[-4] = (r2[-4] + 1) % 4
        planted.setdefault("overlap", []).append(
            frag(s, ins, r2=r2, quals=(flat(37), flat(30, 15 if k < 3
                                                      else 0))))
    # trimmed ends with a short indel: read 1 forward (4 bp deletion),
    # read 2 reverse (3 bp insertion), each with a Q2 tail of 20
    s = 7_200
    del1 = np.concatenate([g[s:s + 45], g[s + 49:s + 104]])
    planted["trim_indel_fwd"] = frag(s, 300, r1=del1,
                                     quals=(flat(37, 20), flat(37)))
    s = 12_400
    src = g[s + 300 - L + 3:s + 300]
    ins2 = np.concatenate([src[:50], rng.integers(0, 4, 3), src[50:]])
    planted["trim_indel_rev"] = frag(s, 300, r2=_rc(ins2),
                                     quals=(flat(37), flat(37, 20)))
    # read 1 at X - 190 forward, read 2 from Y with the 30-base deletion
    fwd2 = np.concatenate([g[Y_AT:Y_AT + 50],
                           g[Y_AT + 50 + Y_GAP:Y_AT + 100 + Y_GAP]])
    rows.append((g[X_AT - 190:X_AT - 90].copy(), _rc(fwd2),
                 np.full(L, 37, np.uint8), np.full(L, 37, np.uint8)))
    planted["indel_move"] = len(rows) - 1
    # read 1 from A (three substitutions), read 2 250 bases on
    read = g[A_AT:A_AT + L].copy()
    for j in (10, 40, 70):
        read[j] = (read[j] + 1) % 4
    rows.append((read, _rc(g[A_AT + 250 - L:A_AT + 250]),
                 np.full(L, 37, np.uint8), np.full(L, 37, np.uint8)))
    planted["disjoined"] = len(rows) - 1
    # read 1 opens with three N and a substitution: the semialigned clip
    # takes five bases, three of them N (a match to the clip, an edit to
    # NM)
    s = 16_400
    r1 = g[s:s + L].copy()
    r1[:3] = 4
    r1[4] = (r1[4] + 1) % 4
    planted["read_n"] = frag(s, 300, r1=r1, quals=(flat(37), flat(37)))
    # read 2 reverse with 5 inserted bases after its 40th: the pair step
    # places it by its longer right part, 5 bases left of its start, where
    # the template is 145 long, under the model's 150; the gapped polish
    # moves it to its start, where the template is 150 long
    s = 17_300
    fwd2 = np.concatenate([g[s + 50:s + 90], rng.integers(0, 4, 5),
                           g[s + 90:s + 145]])
    planted["sw_move"] = frag(s, 150, r2=_rc(fwd2),
                              quals=(flat(37), flat(37)))
    return rows, planted


def _batches(rows):
    n = len(rows)
    names = [f"p{i}" for i in range(n)]
    lengths = np.full(n, L, np.int32)
    return tuple(ReadBatch(list(names), np.stack([r[c] for r in rows]),
                           np.stack([r[c + 2] for r in rows]), lengths.copy())
                 for c in (0, 1))


@pytest.fixture(scope="module")
def fixture():
    g = _genome_codes()
    genome = genome_from_sequences([("chrD", dna.decode(g))])
    rows, planted = _pairs(g)
    return genome, build_index(genome, seed_len=32, device="cpu"), rows, \
        planted


def _run(fixture, monkeypatch=None):
    genome, index, rows, planted = fixture
    al = PairedAligner.create(index, read_len=L, device="cpu")
    al.tls = TlsStatic(**TLS)
    b1, b2 = _batches(rows)
    recs = al.align_to_sam(b1, b2)
    return al, recs, (b1, b2)


@pytest.fixture(scope="module")
def ran(fixture):
    return _run(fixture)


def _reference_of(genome_codes, contigs, recs, b1, b2, i):
    """(reference ends, reference pair, port ends, port pair) of pair i;
    records carry local positions on one contig at offset 0."""
    ends, port = [], []
    for e, rec in enumerate(recs[2 * i:2 * i + 2]):
        batch = (b1, b2)[e]
        aligned = not rec.flag & 4
        rev = bool(rec.flag & 16)
        bases = batch.bases[i]
        if aligned:
            start, ops = clips.unclipped(rec.pos - 1, rec.cigar, L)
        else:
            start, ops = -1, []
        ends.append({"aligned": aligned, "start": start, "reverse": rev,
                     "ops": ops, "bases": bases, "quals": batch.quals[i]})
        port.append(None if not aligned else {
            "pos": rec.pos - 1, "cigar": rec.cigar, "nm": _nm(rec)})
    starts = [c.offset for c in contigs]
    stops = [c.offset + c.length for c in contigs]
    ref_ends, ref_pair = clips.clip_pair(genome_codes, starts, stops, ends,
                                         REF_TLS)
    both = ends[0]["aligned"] and ends[1]["aligned"]
    port_pair = {"proper": bool(recs[2 * i].flag & 2) and both,
                 "tlen": [recs[2 * i].tlen, recs[2 * i + 1].tlen]}
    return ref_ends, ref_pair, port, port_pair


def _nm(rec) -> int:
    return int(rec.tags["NM"][1])


def _disagreements(genome, recs, b1, b2) -> list:
    out = []
    for i in range(b1.count):
        ref_ends, ref_pair, port, port_pair = _reference_of(
            genome.codes, genome.contigs, recs, b1, b2, i)
        for e in (0, 1):
            if port[e] is None:
                continue
            got = (port[e]["pos"], port[e]["cigar"], port[e]["nm"])
            want = (ref_ends[e]["pos"], ref_ends[e]["cigar"],
                    ref_ends[e]["nm"])
            if got != want:
                out.append((i, e + 1, got, want))
        if (port_pair["proper"], port_pair["tlen"]) != \
                (ref_pair["proper"], ref_pair["tlen"]):
            out.append((i, "pair", port_pair, ref_pair))
    return out


def test_every_pair_equals_the_reference(fixture, ran):
    """POS, CIGAR, NM of every aligned end, proper flag and TLEN of every
    pair, as the reference works them out from the port's placements."""
    genome = fixture[0]
    _al, recs, (b1, b2) = ran
    assert _disagreements(genome, recs, b1, b2) == []


def test_fixture_reaches_every_pass(fixture, ran):
    genome, _index, rows, planted = fixture
    al, recs, (b1, b2) = ran
    kinds = {"trimmed": 0, "semialigned": 0, "overlap": 0}
    for i in range(b1.count):
        ref_ends, _pair, _port, _pp = _reference_of(
            genome.codes, genome.contigs, recs, b1, b2, i)
        for end in ref_ends:
            for k in kinds:
                kinds[k] += int(bool(end and end[k]))
    assert kinds["trimmed"] >= 20 and kinds["semialigned"] >= 1 \
        and kinds["overlap"] >= 4, kinds
    assert al.indel_moved >= 1 and al.reclipped >= 1


def test_overlap_clip_keeps_earlier_clips(fixture, ran):
    """Fault 1: the overlap clip of a pair whose reverse end an earlier
    clip (the trim, the semialigned clip) had moved works from that end's
    start and CIGAR, and its NM counts what is still aligned."""
    genome, _index, rows, planted = fixture
    _al, recs, (b1, b2) = ran
    for i in planted["overlap"]:
        ref_ends, _pair, _port, _pp = _reference_of(
            genome.codes, genome.contigs, recs, b1, b2, i)
        rev = [e for e in (0, 1) if recs[2 * i + e].flag & 16]
        assert len(rev) == 1
        r = recs[2 * i + rev[0]]
        assert ref_ends[rev[0]]["overlap"], i
        assert (r.pos - 1, r.cigar, _nm(r)) == (
            ref_ends[rev[0]]["pos"], ref_ends[rev[0]]["cigar"],
            ref_ends[rev[0]]["nm"])
        fwd = recs[2 * i + 1 - rev[0]]
        # the clipped reverse end starts where the forward end stops
        assert r.pos == fwd.pos + clips.ref_span(clips.parse(fwd.cigar, L))


def test_trimmed_indel_ends_are_gap_aligned(fixture, ran):
    """Fault 4: an end whose 3' tail the Q25 trim masked still goes to the
    banded SW: its indel is aligned, its masked tail soft-clipped."""
    genome, _index, rows, planted = fixture
    _al, recs, (b1, b2) = ran
    fwd = recs[2 * planted["trim_indel_fwd"]]
    assert (fwd.pos - 1, fwd.cigar) == (7_200, "45M4D35M20S")
    rev = recs[2 * planted["trim_indel_rev"] + 1]
    assert rev.flag & 16
    assert "3I" in rev.cigar and rev.cigar.startswith("20S")
    # the oriented read starts at 12,603; its first 20 bases are masked
    assert rev.pos - 1 == 12_400 + 300 - L + 3 + 20


def test_simple_indel_move_repairs_the_pair(fixture, ran):
    """Fault 5: the simple-indel aligner moves read 2 from the copy X by
    its mate to its source Y; the pair is no longer proper there, and its
    fields follow the move."""
    genome, _index, rows, planted = fixture
    al, recs, (b1, b2) = ran
    i = planted["indel_move"]
    r1, r2 = recs[2 * i], recs[2 * i + 1]
    assert (r2.pos - 1, r2.cigar) == (Y_AT, f"50M{Y_GAP}D50M")
    assert not r1.flag & 2 and not r2.flag & 2
    assert r1.tlen == -r2.tlen == Y_AT + 130 - (X_AT - 190)
    assert al.indel_repaired >= 1


def test_rescued_disjoined_end_is_clipped_where_it_lands(fixture, ran):
    """Fault 2 (ROADMAP C4): read 1 first lands on the copy A' with a
    device semialigned clip; the rescue moves it to A beside its mate, and
    the clip made for A' is not applied there."""
    genome, _index, rows, planted = fixture
    al, recs, (b1, b2) = ran
    r1, r2 = recs[2 * planted["disjoined"]:2 * planted["disjoined"] + 2]
    assert (r1.pos - 1, r1.cigar, _nm(r1)) == (A_AT, f"{L}M", 3)
    assert r1.flag & 2 and r2.flag & 2
    assert r1.tlen == 250 and al.reclipped >= 1


def test_semialigned_clip_recounts_nm(fixture, ran):
    """A semialigned clip that takes read N bases off recounts NM over
    what stays aligned (the device clip's count of removed mismatches,
    for the scoring, leaves the N out)."""
    _genome, _index, _rows, planted = fixture
    _al, recs, _b = ran
    r1 = recs[2 * planted["read_n"]]
    assert (r1.pos - 1, r1.cigar, _nm(r1)) == (16_405, "5S95M", 0)


def test_trimmed_gapped_fields_equal_a_rescore(fixture):
    """The fields of a trimmed end's gapped walk, the walk's less what the
    clip of its masked tail took, equal `rescore_cigar` of the clipped
    CIGAR over the masked read (log-probabilities to float32, as the
    result holds them)."""
    from isaac_aligner_tpu_torch.align.gapped import rescore_cigar
    from isaac_aligner_tpu_torch.io.bam import parse_cigar
    genome, index, rows, planted = fixture
    al = PairedAligner.create(index, read_len=L, device="cpu")
    al.tls = TlsStatic(**TLS)
    b1, b2 = _batches(rows)
    res = al.align_batch_arrays(b1, b2)
    seen = 0
    for e, b in ((1, b1), (2, b2)):
        for i, cig in enumerate(res[f"cigar_{e}"]):
            if not cig or "S" not in cig or not ("I" in cig or "D" in cig):
                continue
            t = clips.trim_low_quality_end(b.quals[i])
            bases, quals = b.bases[i].copy(), b.quals[i].copy()
            bases[L - t:], quals[L - t:] = 4, 0
            if res[f"reverse_{e}"][i]:
                bases, quals = dna.revcomp(bases), quals[::-1]
            lp, nmm, edit, _norm = rescore_cigar(
                genome.codes, int(res[f"start_{e}"][i]), bases, quals,
                parse_cigar(cig))
            assert (int(res[f"mismatches_{e}"][i]),
                    int(res[f"edit_distance_{e}"][i])) == (nmm, edit)
            # the result holds float32 log-probabilities
            assert abs(float(res[f"log_prob_{e}"][i]) - lp) <= \
                2 * np.spacing(np.float32(abs(lp)))
            seen += 1
    assert seen >= 2


def test_gapped_move_repairs_the_pair(fixture, ran):
    """The proper flag follows the final placements after the gapped
    polish moves an end, too: the pair step saw the template at 145, the
    gapped alignment makes it 150, the model's shortest proper one."""
    _genome, _index, _rows, planted = fixture
    _al, recs, _b = ran
    r1, r2 = recs[2 * planted["sw_move"]:2 * planted["sw_move"] + 2]
    assert (r2.pos - 1, r2.cigar) == (17_350, "40M5I55M")
    assert r1.flag & 2 and r2.flag & 2


def test_spans_nest_under_their_parents(ran):
    al = ran[0]
    t = al.timings
    for child, parent in (("polish.clip.trim", "polish.clip"),
                          ("polish.clip.semialigned", "polish.clip"),
                          ("polish.clip.overlap", "polish.clip"),
                          ("polish.indel.repair", "polish.indel")):
        assert child in t and parent in t
        assert t[child] <= t[parent] + 1e-9


class _Watch:
    """Result arrays around the passes, per aligner: the ends the rescue
    moved while aligned, the pair fields after it, each end's placement
    before the gapped polish, and the rows the simple-indel aligner and
    the two polish passes together changed."""

    def __init__(self, monkeypatch):
        self.by = {}
        orig_rescue = PairedAligner._apply_rescue
        orig_gapped = port_aligner.polish_gapped
        orig_indel = port_aligner.polish_simple_indels
        watch = self

        def of(res):
            return next(w for w in watch.by.values() if w["res"] is res)

        def rescue(al, res, b1, b2):
            before = (res["aligned_1"].copy(), res["aligned_2"].copy())
            hit = orig_rescue(al, res, b1, b2)
            watch.by[id(al)] = {
                "res": res, "placed": {}, "moved": {}, "indel": 0,
                "reclipped": int((hit[0] & before[0]).sum()
                                 + (hit[1] & before[1]).sum()),
                "pair": {k: res[k].copy() for k in
                         ("proper_pair", "pair_resolved", "template_length")}}
            return hit

        def gapped(index, cfg, res, bases, device, suffix="", **kw):
            of(res)["placed"][suffix] = (res["start" + suffix].copy(),
                                         res["reverse" + suffix].copy(),
                                         list(res["cigar" + suffix]))
            return orig_gapped(index, cfg, res, bases, device, suffix, **kw)

        def indel(index, cfg, res, bases, suffix="", **kw):
            cig = list(res["cigar" + suffix])
            out = orig_indel(index, cfg, res, bases, suffix, **kw)
            w = of(res)
            w["indel"] += sum(a != b for a, b in zip(cig,
                                                     res["cigar" + suffix]))
            start, rev, before = w["placed"][suffix]
            w["moved"][suffix] = {
                i for i in range(len(cig))
                if (res["start" + suffix][i], res["reverse" + suffix][i],
                    res["cigar" + suffix][i]) != (start[i], rev[i],
                                                  before[i])}
            return out

        monkeypatch.setattr(PairedAligner, "_apply_rescue", rescue)
        monkeypatch.setattr(port_aligner, "polish_gapped", gapped)
        monkeypatch.setattr(port_aligner, "polish_simple_indels", indel)

    def expected(self, al) -> dict:
        w = self.by[id(al)]
        res = w["res"]
        moved = set().union(*w["moved"].values())
        repaired = sum(
            int(any(w["pair"][k][i] != res[k][i] for k in w["pair"]))
            for i in moved)
        return {"reclipped": w["reclipped"], "indel_moved": w["indel"],
                "indel_repaired": repaired, "res": res}


def _clip_counts(codes, contigs, res, b1, b2, offset=0):
    """Trimmed, semialigned and overlap-clipped ends of one aligner's
    result arrays, by the reference from its placements."""
    n = {"trimmed_ends": 0, "semialigned_clipped": 0, "overlap_clipped": 0}
    for b in (b1, b2):
        n["trimmed_ends"] += sum(
            int(clips.trim_low_quality_end(q) > 0) for q in b.quals)
    starts = [c.offset for c in contigs]
    stops = [c.offset + c.length for c in contigs]
    for i in range(b1.count):
        ends = []
        for e, b in ((1, b1), (2, b2)):
            aligned = bool(res[f"aligned_{e}"][i])
            cig = res[f"cigar_{e}"][i] if aligned else None
            st, ops = clips.unclipped(int(res[f"start_{e}"][i]), cig, L) \
                if aligned else (-1, [])
            ends.append({"aligned": aligned, "start": st,
                         "reverse": bool(res[f"reverse_{e}"][i]), "ops": ops,
                         "bases": b.bases[i], "quals": b.quals[i]})
        got, _pair = clips.clip_pair(codes, starts, stops, ends, REF_TLS)
        for end in got:
            if end:
                n["semialigned_clipped"] += int(end["semialigned"])
                n["overlap_clipped"] += int(end["overlap"])
    return n


COUNTERS = ("trimmed_ends", "semialigned_clipped", "reclipped",
            "overlap_clipped", "indel_moved", "indel_repaired")


def test_counters_equal_the_result_arrays(fixture, monkeypatch):
    genome, index, rows, planted = fixture
    watch = _Watch(monkeypatch)
    al = PairedAligner.create(index, read_len=L, device="cpu")
    al.tls = TlsStatic(**TLS)
    b1, b2 = _batches(rows)
    al.align_batch_arrays(b1, b2)
    exp = watch.expected(al)
    exp.update(_clip_counts(genome.codes, genome.contigs, exp.pop("res"),
                            b1, b2))
    assert {k: getattr(al, k) for k in COUNTERS} == exp
    assert all(exp[k] > 0 for k in COUNTERS), exp


def test_counters_sum_over_two_groups(fixture, monkeypatch):
    """Two contig groups (the genome cut in two at 10 kbp): each group's
    counters equal its own result arrays, and the driver sums them."""
    genome, _index, rows, planted = fixture
    g = genome.codes
    halves = [genome_from_sequences([(f"chr{k}",
                                      dna.decode(g[k * 10_000:(k + 1) * 10_000]))])
              for k in (0, 1)]
    mal = MultiIndexPairedAligner.create(
        [build_index(h, seed_len=32, device="cpu") for h in halves],
        read_len=L, device="cpu")
    watch = _Watch(monkeypatch)
    mal.tls = TlsStatic(**TLS)
    b1, b2 = _batches(rows)
    mal.align_batch_arrays(b1, b2)
    total = dict.fromkeys(COUNTERS, 0)
    for al, h in zip(mal.aligners, halves):
        exp = watch.expected(al)
        exp.update(_clip_counts(h.codes, h.contigs, exp.pop("res"), b1, b2))
        assert {k: getattr(al, k) for k in COUNTERS} == exp
        for k in COUNTERS:
            total[k] += exp[k]
    assert {k: getattr(mal, k) for k in COUNTERS} == total


# -- helpers of the tests that hold the port to the JAX package at the
# defaults: equal where no mended fault touches a pair, and there the port
# holds to the reference while the JAX package does not


def res_reference(codes, contigs, res, b1, b2, i, tls, read_len=L):
    """(reference ends, reference pair) of row i of a paired result dict,
    from its ends' unclipped placements (`clips.unclipped`)."""
    ends = []
    for e, b in ((1, b1), (2, b2)):
        aligned = bool(res[f"aligned_{e}"][i])
        cig = (res.get(f"cigar_{e}") or [None] * b.count)[i]
        st, ops = clips.unclipped(int(res[f"start_{e}"][i]), cig, read_len) \
            if aligned else (-1, [])
        ends.append({"aligned": aligned, "start": st,
                     "reverse": bool(res[f"reverse_{e}"][i]), "ops": ops,
                     "bases": b.bases[i], "quals": b.quals[i]})
    return clips.clip_pair(codes, [c.offset for c in contigs],
                           [c.offset + c.length for c in contigs], ends, tls)


def _record_answer(rec, offsets):
    if rec.flag & 4:
        return None
    return (offsets[rec.rname] + rec.pos - 1, rec.cigar,
            int(rec.tags["NM"][1]), bool(rec.flag & 2), rec.tlen)


def _records_reference(genome, pair, tls):
    """Reference answers (global POS, CIGAR, NM, proper, TLEN) of a pair's
    two BAM records (read 1 first), from their unclipped placements."""
    offsets = {c.name: c.offset for c in genome.contigs}
    ends = []
    for rec in pair:
        seq = dna.encode(rec.seq)
        qual = np.frombuffer(rec.qual.encode(), np.uint8) - 33
        rev = bool(rec.flag & 16)
        if rev:
            seq, qual = dna.revcomp(seq), qual[::-1]
        aligned = not rec.flag & 4
        st, ops = clips.unclipped(offsets[rec.rname] + rec.pos - 1,
                                  rec.cigar, len(seq)) if aligned \
            else (-1, [])
        ends.append({"aligned": aligned, "start": st, "reverse": rev,
                     "ops": ops, "bases": seq, "quals": qual})
    got, p = clips.clip_pair(genome.codes, [c.offset for c in genome.contigs],
                             [c.offset + c.length for c in genome.contigs],
                             ends, tls)
    both = got[0] is not None and got[1] is not None
    return [None if g is None else
            (g["pos"], g["cigar"], g["nm"], p["proper"] and both, t)
            for g, t in zip(got, p["tlen"])]


def bam_pairs(path) -> dict:
    from isaac_aligner_tpu_torch.io.bam import read_bam
    out: dict = {}
    for rec in read_bam(path)[2]:
        out.setdefault(rec.qname, [None, None])[0 if rec.flag & 64 else 1] \
            = rec
    return out


def assert_bam_equal_but_mended(jax_bam, port_bam, genome, tls) -> set:
    """The port's BAM holds the JAX package's records but on the pairs a
    mended fault touches: there the port's answers (POS, CIGAR, NM, proper
    flag, TLEN) are the reference's and the JAX package's are not, and on
    every other pair both are the reference's.  Returns the touched names
    (and adds to `assert_bam_equal_but_mended.proper_delta` the port's
    proper pairs less the JAX package's among them)."""
    jp, tp = bam_pairs(jax_bam), bam_pairs(port_bam)
    assert jp.keys() == tp.keys()
    offsets = {c.name: c.offset for c in genome.contigs}
    touched = set()
    for name, tpair in tp.items():
        jpair = jp[name]
        want = _records_reference(genome, tpair, tls)
        port = [_record_answer(r, offsets) for r in tpair]
        assert port == want, (name, port, want)
        if jpair == tpair:
            continue
        touched.add(name)
        assert [_record_answer(r, offsets) for r in jpair] != want, name
        assert_bam_equal_but_mended.proper_delta += \
            int(bool(tpair[0].flag & 2)) - int(bool(jpair[0].flag & 2))
        for a, b in zip(jpair, tpair):   # the rest of each record alike
            for f in ("flag", "rname", "mapq", "seq", "qual", "rnext"):
                assert getattr(a, f) == getattr(b, f) or f == "flag" and \
                    (a.flag | 2) == (b.flag | 2), (name, f)
    return touched


assert_bam_equal_but_mended.proper_delta = 0


def workflow_tls(out) -> dict:
    """The reference's pair model from a workflow's saved TLS."""
    import json
    t = json.loads((Path(out) / "Temp" / "AlignerState.json").read_text())
    t = t["tls"]
    return {"min": t["min"], "max": t["max"], "best": (t["best0"], t["best1"])}


def assert_outputs_equal_but_mended(jout, tout, genome) -> dict:
    """`test_torch_bcl.assert_outputs_equal` at the defaults: every output
    byte-equal but a BAM that a mended fault touches
    (`assert_bam_equal_but_mended`), whose .md5 is then its own bytes' and
    whose .bai is an index of as many contigs that finds every record of
    the port's BAM (region queries tiling the contigs, held against a scan
    of the records: `bamfile.bai_errors`), and the Stats' count of proper
    pairs, which differs by the touched pairs' proper flags.  Returns {BAM
    name: touched read names}."""
    import hashlib
    import json

    from test_torch_bcl import UNTIMED, output_files
    jout, tout = Path(jout), Path(tout)
    names = output_files(jout)
    assert output_files(tout) == names
    tls = workflow_tls(tout)
    touched = {}
    assert_bam_equal_but_mended.proper_delta = 0
    # the BAMs first: their touched pairs set what the Stats may differ by
    for name in sorted(names, key=lambda n: not n.endswith(".bam")):
        a, b = (jout / name).read_bytes(), (tout / name).read_bytes()
        if name.endswith(".json"):
            a, b = json.loads(a), json.loads(b)
            if isinstance(a, dict):
                a = {k: v for k, v in a.items() if k not in UNTIMED}
                b = {k: v for k, v in b.items() if k not in UNTIMED}
            if name.endswith("MatchSelectorStats.json"):
                a["proper_pairs"] += assert_bam_equal_but_mended.proper_delta
            assert a == b, name
        elif a != b:
            bam = name.rsplit(".", 1)[0] if not name.endswith(".bam") \
                else name
            assert (jout / bam).read_bytes() != (tout / bam).read_bytes(), \
                name
            if name.endswith(".bam"):
                touched[name] = assert_bam_equal_but_mended(
                    jout / name, tout / name, genome, tls)
                assert touched[name], name
            elif name.endswith(".md5"):
                assert b.decode().split()[0] == hashlib.md5(
                    (tout / bam).read_bytes()).hexdigest()
            else:
                assert b[:4] == a[:4] == b"BAI\x01" and b[4:8] == a[4:8]
                assert bamfile.bai_errors(
                    bamfile.Bam(tout / bam), np.random.default_rng(0),
                    n_queries=64, width=1_000) == 0, name
    return touched


#: the known-gap site of the workflow case, and its 4 bp deletion
GAP_AT, GAP_LEN = 5_500, 4


def _gap_rows(g: np.ndarray):
    """Pairs for the workflow case: 28 plain pairs; 4 pairs whose read 1
    carries the deletion at GAP_AT mid-read (the gapped polish aligns it,
    so Build knows the gap); and the pair `clipped`: read 1 forward across
    GAP_AT without the deletion (a row the realigner weighs, so Build
    patches its pair), read 2 reverse 10 bases further on with four
    substitutions among its first 13 sequenced bases (its genome-right
    end; too few for the gapped polish), which the semialigned clip takes
    off: read 2 then stops 3 bases short of read 1's end."""
    rng = np.random.default_rng(1503)
    q = np.full(L, 37, np.uint8)
    rows = []
    plain = [s for s in range(300, 19_000, 450)
             if min(abs(s - x) for x in (X_AT, GAP_AT, A_AT, Y_AT, A2_AT))
             > 700][:30]
    for k, s in enumerate(plain):
        ins = int(rng.integers(260, 340))
        rows.append((f"plain{k}", g[s:s + L].copy(),
                     _rc(g[s + ins - L:s + ins]), q, q))
    for k in range(4):
        p = GAP_AT - 30 - 7 * k
        r1 = np.concatenate([g[p:GAP_AT], g[GAP_AT + GAP_LEN:
                                            GAP_AT + GAP_LEN + L - (GAP_AT - p)]])
        rows.append((f"donor{k}", r1, _rc(g[p + 200:p + 300]), q, q))
    s = GAP_AT - 40
    r2 = _rc(g[s + 10:s + 110]).copy()
    for j in (0, 4, 8, 12):
        r2[j] = (r2[j] + 1) % 4
    rows.append(("clipped", g[s:s + L].copy(), r2, q, q))
    return rows


def test_realigned_pair_tlen_follows_the_clipped_ends(fixture, tmp_path,
                                                      monkeypatch):
    """Fault 3: Build's gap realignment patches the mate fields of every
    pair with a row over a known gap; the pair whose read 2 the
    semialigned clip left short of read 1's end keeps the TLEN of its
    final placements (the reference's), which the JAX package's patch
    cuts to read 2's end.  Every other record is the JAX package's."""
    from isaac_aligner_tpu.workflow import align as jwf
    from isaac_aligner_tpu_torch.workflow import align as wf
    from test_torch_paired import write_pair_inputs

    genome = fixture[0]
    d = tmp_path / "in"
    d.mkdir()
    write_pair_inputs(d, _gap_rows(genome.codes), genome)
    monkeypatch.setenv("ISAAC_TPU_OUTPUT_PROC", "0")
    outs = []
    for mod in (jwf, wf):
        out = tmp_path / mod.__name__.split(".")[0]
        kw = dict(reference=str(d / "ref.fa"), output_dir=str(out),
                  fastq1=str(d / "r1.fq"), fastq2=str(d / "r2.fq"),
                  batch_size=64, tls_override="230:300:370:20:20:1:6")
        if mod is wf:
            kw["device"] = "cpu"
        mod.AlignWorkflow(mod.WorkflowOptions(**kw)).run()
        outs.append(out)
    touched = assert_outputs_equal_but_mended(*outs, genome)
    assert touched == {"sorted.bam": {"clipped"}}
    r1, r2 = bam_pairs(outs[1] / "sorted.bam")["clipped"]
    assert r2.cigar == "87M13S" and r1.cigar == f"{L}M"
    assert r1.tlen == -r2.tlen == L
