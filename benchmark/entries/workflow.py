"""The `workflow` entry: whole FASTQ.gz pair -> sorted, duplicate-marked,
realigned BAM (+ .bai, .md5) jobs of the program's workflow, back to back
in a closed loop with one client, at the workflow's defaults.

Set-up writes the library as a gzipped FASTQ pair once and runs one
whole job on its first `warmup_pairs` pairs (as many batches as TLS
learning reads, the job's batch shape) to build and warm every kernel and
helper; the window runs jobs until
`--seconds` have passed and counts all the reads of the jobs it ran over
all their time.  Each job's output, and the candidate lists the reference
follows for the templates the check will judge, stay until the window has
closed and its check is done, then go.
"""

from __future__ import annotations

import shutil
import time
from pathlib import Path

import numpy as np

import generator
import program
from entries import checks
from reference import bamfile
from reference.judge import make_judge


class Workflow:
    def __init__(self, ctx):
        self.ctx = ctx
        lib = ctx.library
        self.fq = [ctx.workdir / "reads_1.fastq.gz",
                   ctx.workdir / "reads_2.fastq.gz"]
        for e in (0, 1):
            generator.write_fastq_gz(self.fq[e], lib.bases[e], lib.quals[e])
        self.options = dict(ctx.config.get("options", {}))
        self.jobs: list[dict] = []
        self.cands: dict = {}
        warm = [ctx.workdir / "warm_1.fastq.gz", ctx.workdir / "warm_2.fastq.gz"]
        k = int(ctx.traffic["warmup_pairs"])
        for e in (0, 1):
            generator.write_fastq_gz(warm[e], lib.bases[e, :k],
                                     lib.quals[e, :k])
        self._job(ctx.workdir / "warm", warm)
        shutil.rmtree(ctx.workdir / "warm", ignore_errors=True)
        for p in warm:
            p.unlink()

    def _job(self, out: Path, fq=None) -> dict:
        fq = fq or self.fq
        t0 = time.perf_counter()
        stats = program.run_workflow(self.ctx.index_path, fq[0], fq[1], out,
                                     self.ctx.device, self.options)
        return {"out": out, "seconds": time.perf_counter() - t0,
                "stats": stats}

    def choose_rows(self, rng: np.random.Generator, per_job: int) -> None:
        """The templates the check will judge in every job."""
        pairs = self.ctx.library.pairs
        self.templates = np.sort(rng.choice(pairs, min(per_job, pairs),
                                            replace=False))

    def window(self, seconds: float) -> dict:
        reads = 2 * self.ctx.library.pairs
        k = 0
        with program.candidates_kept(self.cands, self.templates):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                job = self._job(self.ctx.workdir / f"job{k}")
                job["cands"] = dict(self.cands)
                self.jobs.append(job)
                k += 1
            elapsed = time.perf_counter() - t0
        return {"units": len(self.jobs), "reads": reads * len(self.jobs),
                "elapsed": elapsed, "record": self._record()}

    def _record(self) -> dict:
        stage, build, upload, sw = {}, 0.0, 0.0, 0
        for j in self.jobs:
            ms = j["stats"]["MatchSelectorStats"]
            for key, v in ms.get("stage_seconds", {}).items():
                stage[key] = stage.get(key, 0.0) + float(v)
            build += float(j["stats"]["BuildStats"]["build_seconds"])
            sw += int(ms.get("device_work", {}).get("sw_pairs", 0))
        upload = stage.get("upload")
        return {"entry": "workflow", "jobs": len(self.jobs),
                "reads": 2 * self.ctx.library.pairs * len(self.jobs),
                "stage_seconds": stage, "build_seconds": build,
                "upload_seconds": upload, "sw_pairs": sw,
                "job_seconds": [j["seconds"] for j in self.jobs]}

    def traced(self) -> dict:
        """One more whole job, for the device trace."""
        out = self.ctx.workdir / "traced"
        t0 = time.perf_counter()
        program.run_workflow(self.ctx.index_path, self.fq[0], self.fq[1],
                             out, self.ctx.device, self.options)
        wall = time.perf_counter() - t0
        shutil.rmtree(out, ignore_errors=True)
        return {"wall": wall}

    def release(self) -> None:
        pass

    def check(self, rng: np.random.Generator, sample: int) -> dict:
        """The reference's numbers over every job of the window: exact
        counts summed, `misplaced_pct` over the judged ends of all jobs."""
        ctx = self.ctx
        pairs = checks.Pairs(ctx, make_judge(ctx))
        totals = dict.fromkeys(BAM_EXACT, 0)
        tally = checks.Tally()
        bad_units = 0
        for j in self.jobs:
            got, verdict = check_bam(j["out"] / "sorted.bam", ctx, pairs,
                                     self.templates, j["cands"], rng)
            for key in BAM_EXACT:
                totals[key] += got[key]
            tally.add(verdict)
            bad_units += int(any(got.values()) or verdict.bad())
            shutil.rmtree(j["out"], ignore_errors=True)
        out = tally.numbers()
        out["missing"] += totals.pop("missing")
        out.update(totals)
        out["_bad_units"] = bad_units
        return out


BAM_EXACT = ("missing", "seq_wrong", "mate_wrong", "order_wrong",
             "md5_wrong", "bai_wrong", "dup_wrong", "mapq_field_wrong")


def _template_index(bam: bamfile.Bam, pairs: int):
    """Record rows of read 1 and read 2 of each template (-1 when absent)
    and the count of templates without exactly one of each."""
    names = bam.names()
    tid = np.fromiter((int(n[1:]) if n[:1] == "t" and n[1:].isdigit() else -1
                       for n in names), np.int64, len(names))
    rows = np.full((2, pairs), -1, np.int64)
    count = np.zeros((2, pairs), np.int64)
    ok = (tid >= 0) & (tid < pairs)
    end = np.where(bam.flag & 0x40, 0, 1)
    for e in (0, 1):
        sel = ok & (end == e)
        np.add.at(count[e], tid[sel], 1)
        rows[e, tid[sel]] = np.nonzero(sel)[0]
    missing = int(((count != 1).any(axis=0)).sum()) + int((~ok).sum())
    return rows, missing


def _tlen(pos_a, len_a, pos_b, len_b) -> int:
    if pos_a < pos_b:
        return max(pos_b + len_b - pos_a, len_a)
    return max(pos_a + len_a - pos_b, len_b)


def _mate_errors(bam: bamfile.Bam, a: int, b: int, a_is_read1: bool) -> int:
    """Fields of record `a` that disagree with its mate `b`."""
    fa, fb = int(bam.flag[a]), int(bam.flag[b])
    a_mapped, b_mapped = not fa & 4, not fb & 4
    bad = 0
    bad += int(bool(fa & 8) != (not b_mapped))
    if b_mapped:
        bad += int(bool(fa & 0x20) != bool(fb & 0x10))
        bad += int(bam.next_ref_id[a] != bam.ref_id[b]
                   or bam.next_pos[a] != bam.pos[b])
    elif a_mapped:
        bad += int(bam.next_ref_id[a] != bam.ref_id[a]
                   or bam.next_pos[a] != bam.pos[a])
    if not a_mapped and b_mapped:
        bad += int(bam.ref_id[a] != bam.ref_id[b] or bam.pos[a] != bam.pos[b])
    tlen = 0
    if a_mapped and b_mapped and bam.ref_id[a] == bam.ref_id[b]:
        mag = _tlen(int(bam.pos[a]), bam.ref_len(a), int(bam.pos[b]),
                    bam.ref_len(b))
        first = bam.pos[a] < bam.pos[b] or (bam.pos[a] == bam.pos[b]
                                            and a_is_read1)
        tlen = mag if first else -mag
    bad += int(int(bam.tlen[a]) != tlen)
    return bad


def _dup_errors(bam: bamfile.Bam, rows: np.ndarray, lib) -> int:
    """Planted duplicate groups whose members are all aligned alike (both
    ends mapped, same reference, position, strand and CIGAR) and of which
    more than one is left unflagged.  (None flagged is no error: another
    template with the same unclipped 5' anchors may outrank them.)"""
    groups: dict[int, list[int]] = {}
    for i in np.nonzero(lib.dup_of >= 0)[0]:
        groups.setdefault(int(lib.dup_of[i]), []).append(int(i))
    flag, ref, pos = bam.flag, bam.ref_id, bam.pos
    r1, r2 = rows
    errors = 0
    for src, copies in groups.items():
        members = [src] + copies
        if any(r1[t] < 0 or r2[t] < 0 for t in members):
            continue
        sig = set()
        for t in members:
            x, y = int(r1[t]), int(r2[t])
            if flag[x] & 4 or flag[y] & 4:
                sig.add(None)
                break
            sig.add((int(ref[x]), int(pos[x]), int(flag[x] & 0x10),
                     tuple(bam.cigar(x)), int(ref[y]), int(pos[y]),
                     int(flag[y] & 0x10), tuple(bam.cigar(y))))
        if len(sig) != 1 or None in sig:
            continue
        unflagged = sum(1 for t in members if not flag[r1[t]] & 0x400)
        errors += int(unflagged > 1)
    return errors


def _cigar_str(ops) -> str:
    return "".join(f"{n}{op}" for n, op in ops)


def _mapq_field_errors(bam: bamfile.Bam, i: int, cap: int) -> int:
    """1 when a mapped record's MAPQ is not the larger of its SM and AS
    tags for a proper pair (SM alone otherwise), capped at `cap`."""
    sm = bam.int_tag(i, "SM")
    if sm is None:
        return 1
    as_ = bam.int_tag(i, "AS")
    want = max(sm, as_) if bam.flag[i] & 2 and as_ is not None else sm
    return int(int(bam.mapq[i]) != min(cap, want))


def check_bam(path: Path, ctx, pairs: checks.Pairs, templates: np.ndarray,
              cands: dict, rng) -> tuple[dict, checks.Tally]:
    """The numbers of one job's BAM: every record for order, MD5, BAI,
    presence and duplicates; the templates `templates` for the stored
    read, the mate fields, the MAPQ field, and (through `pairs`)
    placement, NM, mapping quality and the proper flag.  The BAM holds no
    log-probability: that of each end is the one the aligner handed on to
    Build with the same alignment, from `cands`."""
    lib, genome = ctx.library, ctx.genome
    bam = bamfile.Bam(path)
    rows, missing = _template_index(bam, lib.pairs)
    out = {"missing": missing, "order_wrong": bam.order_errors(),
           "md5_wrong": bam.md5_errors(),
           "bai_wrong": bamfile.bai_errors(bam, rng),
           "dup_wrong": _dup_errors(bam, rows, lib),
           "seq_wrong": 0, "mate_wrong": 0, "mapq_field_wrong": 0}
    ref_offsets = np.array([int(genome.offsets[genome.names.index(name)])
                            for name, _len in bam.refs], np.int64)
    cap = pairs.cap
    held = pairs.by_template(cands)
    present = (rows[:, templates] >= 0).all(axis=0)
    ts = templates[present]
    n = len(ts)
    ends = [{"aligned": np.zeros(n, bool),
             "start": np.full(n, -1, np.int64),
             "reverse": np.zeros(n, bool),
             "edit_distance": np.zeros(n, np.int64),
             "frag_score": np.zeros(n, np.int64),
             "log_prob": np.full(n, np.nan), "cigar": [None] * n}
            for _ in (0, 1)]
    proper = np.zeros(n, bool)
    for j, t in enumerate(ts.tolist()):
        for e in (0, 1):
            i, m = int(rows[e, t]), int(rows[1 - e, t])
            flag = int(bam.flag[i])
            s, q = bam.seq_qual(i)
            if flag & 0x10:
                s, q = generator.revcomp(s), q[::-1]
            out["seq_wrong"] += int(not (
                np.array_equal(s, lib.bases[e, t])
                and np.array_equal(q, lib.quals[e, t])))
            out["mate_wrong"] += _mate_errors(bam, i, m, e == 0)
            if flag & 4:
                continue
            out["mapq_field_wrong"] += _mapq_field_errors(bam, i, cap)
            end = ends[e]
            end["aligned"][j] = True
            end["start"][j] = ref_offsets[int(bam.ref_id[i])] + int(bam.pos[i])
            end["reverse"][j] = bool(flag & 0x10)
            nm = bam.int_tag(i, "NM")
            end["edit_distance"][j] = -1 if nm is None else nm
            end["frag_score"][j] = bam.int_tag(i, "SM") or 0
            end["cigar"][j] = _cigar_str(bam.cigar(i))
            if t in held:
                end["log_prob"][j] = pairs.handed_on_log_prob(
                    held[t], f"_{e + 1}", int(end["start"][j]),
                    bool(end["reverse"][j]))
        f1, f2 = int(bam.flag[rows[0, t]]), int(bam.flag[rows[1, t]])
        proper[j] = bool(f1 & 2)
        out["mate_wrong"] += int(bool(f1 & 2) != bool(f2 & 2))
    verdict = checks.Tally()
    pairs.rows(verdict, ts, ends, proper, held)
    return out, verdict
