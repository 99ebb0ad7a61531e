"""Multi-index alignment: genomes beyond one index's address space.

Port of `isaac_aligner_tpu/parallel/multi_index.py`.  A single index
addresses < 2^31 bases (int32 position planes, `index/build.py`), so a
whole human genome (3.1 Gbp) splits into contig GROUPS, each under the
limit, built as independent indexes (`index/groups.py`; the reference
instead widens positions to 40 bits, ReferencePosition.hh:55-180).

The aligners run the device pipeline against every group and merge
per-read results vectorized on the host with exact cross-group MAPQ: each
group reports its best log-probability and its in-group neighborhood
probability mass (others_sum), so the merged neighborhood is

    others_total = sum_g others_g + sum_{g != best} exp(best_lp_g)

and MAPQ re-derives from (best_lp, others_total) with the rest-of-genome
prior over the TOTAL genome length, the single-index math re-associated
on the host.  The merged result dict holds positions in the concatenated
(all-groups) coordinate space, so the columnar converters take it as
they take a single-index result.  The merges are the
JAX package's, unchanged.

Two regimes:
- all groups resident (default): each batch enqueues every group's device
  program before the first fetch, then finishes the groups in order;
  batches run in order;
- group-major (`group_major=True`, planes beyond the card's memory): one
  group's planes on the card at a time; every batch runs through group g,
  g is released (its memory returned to the card), g+1 uploads, and the
  per-batch results merge at the end.

The JAX package's fetch worker threads (`_pipelined_results`) and the
garbage-collector pass after each group (the TPU link's host staging) are
left behind.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..align import quality
from ..aligner import Aligner, PairedAligner
from ..graphs import GraphPool, check_replay_order
from ..index.build import SeedIndex
from ..io import sam
from ..io.fastq import ReadBatch
from ..utils import tracing


def _check_disjoint(indexes: list[SeedIndex]) -> None:
    names = set()
    for ix in indexes:
        for c in ix.genome.contigs:
            if c.name in names:
                raise ValueError(f"contig {c.name} in more than one index")
            names.add(c.name)


def _combined_genome(genomes) -> "object":
    """Contig metadata of the concatenated coordinate space of `genomes`
    (codes are concatenated too so downstream polish/build passes can
    gather)."""
    from ..io.fasta import ContigMeta, Genome
    contigs, arrays, off, k = [], [], 0, 0
    for g in genomes:
        for c in g.contigs:
            contigs.append(ContigMeta(index=k, name=c.name,
                                      offset=off + c.offset,
                                      length=c.length, md5=c.md5))
            k += 1
        arrays.append(g.codes)
        off += g.total_length
    return Genome(codes=np.concatenate(arrays), contigs=contigs)


def _pick_rows(results: list[dict], key: str, best_g: np.ndarray):
    """results[g][key][i] for g = best_g[i], vectorized (object-aware)."""
    n = len(best_g)
    v0 = results[0].get(key)
    if v0 is None:
        return None
    if isinstance(v0, list):
        arr = np.empty((len(results), n), object)
        for g, r in enumerate(results):
            arr[g, :] = r[key]
        picked = arr[best_g, np.arange(n)]
        return list(picked)
    stacked = np.stack([np.asarray(r[key]) for r in results])
    return stacked[best_g, np.arange(n)]


def _group_major_many(aligners, batches, run_one, record, merge):
    """Group-major streaming: upload group g, run EVERY batch through it
    in order, release g, continue; one group's planes on the card at a
    time (the reference instead streams mask FILES from disk per thread,
    MatchFinder.cpp:190-316).

    Batches are materialized once and replayed per group (RAM = the run's
    read bytes).  Per-group stats are recorded in batch order, so the
    per-batch tallies merge by batch index.  Yields (batch,
    merged-results) in batch order."""
    batches = list(batches)
    per_group: list[list] = []
    for a in aligners:
        a.ensure_uploaded()
        outs: list = []
        for b in batches:
            res = run_one(a, b)
            record(a, b, res)
            outs.append(res)
        per_group.append(outs)
        a.release_device()
    for i, b in enumerate(batches):
        yield b, merge(b, [g[i] for g in per_group])


def _share_pool(aligners: list) -> list:
    """One CUDA graph memory pool for every group's device programs: the
    groups capture and replay in group order (`_dispatch_all` and the
    group-major loop), so one program's transient memory serves them all
    (`graphs.py`)."""
    pool = GraphPool()
    for a in aligners:
        a.graphs.pool = pool
    return aligners


def _merged_finder_stats(aligners, anomalous) -> dict:
    merged: dict = {}
    for a in aligners:
        for k, v in a.finder_stats.items():
            if k == "tally":
                # per-batch tallies: groups see the same batches, so
                # merge per batch index
                acc = merged.setdefault("tally", [])
                for i, t in enumerate(v):
                    if i >= len(acc):
                        acc.append(dict(t))
                    else:
                        for tk, tv in t.items():
                            acc[i][tk] = acc[i].get(tk, 0) + tv
            elif k == "anomalous_pairs":
                # counted on the MERGED template in _merge — a
                # per-group sum tallies one template per group
                continue
            else:
                merged[k] = merged.get(k, 0) + v
    if anomalous is not None:
        merged["anomalous_pairs"] = anomalous
    return merged


class _GroupsMixin:
    """What both multi-index aligners share: the groups' summed counters
    and timings, and the combined coordinate space."""

    @property
    def own_timings(self) -> dict:
        """Wall seconds of the driver's own stage spans (`merge`)."""
        if getattr(self, "_own_timings", None) is None:
            self._own_timings = {}
        return self._own_timings

    @property
    def cfg(self):
        return self.aligners[0].cfg

    @property
    def total_genome_length(self) -> int:
        return sum(a.index.genome.total_length for a in self.aligners)

    def combined_genome(self):
        if getattr(self, "_combined", None) is None:
            self._combined = _combined_genome(
                [a.index.genome for a in self.aligners])
        return self._combined

    @property
    def timings(self) -> dict:
        out = dict(self.own_timings)
        for a in self.aligners:
            for k, v in a.timings.items():
                out[k] = out.get(k, 0.0) + v
        return out

    def _summed(self, name: str) -> int:
        return sum(getattr(a, name) for a in self.aligners)

    # the polish passes' counters (Aligner), summed over the groups: each
    # group polishes its own alignment of every read
    trimmed_ends = property(lambda self: self._summed("trimmed_ends"))
    semialigned_clipped = property(
        lambda self: self._summed("semialigned_clipped"))
    reclipped = property(lambda self: self._summed("reclipped"))
    overlap_clipped = property(lambda self: self._summed("overlap_clipped"))
    indel_moved = property(lambda self: self._summed("indel_moved"))
    indel_repaired = property(lambda self: self._summed("indel_repaired"))
    # how the groups' device programs ran (graphs.ProgramGraphs)
    graph_replays = property(lambda self: self._summed("graph_replays"))
    graph_captures = property(lambda self: self._summed("graph_captures"))
    eager_dispatches = property(
        lambda self: self._summed("eager_dispatches"))


@dataclasses.dataclass
class MultiIndexAligner(_GroupsMixin):
    """Single-end alignment across several contig-group indexes.

    `group_major=True` is the beyond-device-memory regime: groups upload
    ONE AT A TIME — the run streams group-major (all batches through group
    g, free g, upload g+1) and merges per batch at the end.  With all
    groups resident (default), each batch dispatches to every group before
    the first fetch."""

    aligners: list[Aligner]
    group_major: bool = False

    @staticmethod
    def create(indexes: list[SeedIndex], read_len: int,
               group_major: bool = False, **opts) -> "MultiIndexAligner":
        _check_disjoint(indexes)
        return MultiIndexAligner(
            _share_pool([Aligner.create(ix, read_len=read_len,
                                        defer_upload=group_major, **opts)
                         for ix in indexes]), group_major=group_major)

    @property
    def finder_stats(self):
        return _merged_finder_stats(self.aligners, None)

    @property
    def sw_pairs(self) -> int:
        return self._summed("sw_pairs")

    @property
    def sw_accepted(self) -> int:
        return self._summed("sw_accepted")

    def _dispatch_all(self, batch: ReadBatch) -> list:
        """Launch every group's device program, in group order, before
        fetching any (a group's replayed outputs stay valid until its next
        dispatch, which comes after `_finish_all`; the groups' graphs must
        replay in their capture order, `graphs.check_replay_order`)."""
        for a in self.aligners:
            a.ensure_uploaded()
        pending = [a._dispatch(batch) for a in self.aligners]
        check_replay_order([a.graphs for a in self.aligners])
        return pending

    def _finish_all(self, batch: ReadBatch, pendings: list) -> list[dict]:
        out = []
        for a, p in zip(self.aligners, pendings):
            res = a._finish(p)
            a._record_stats(batch, res)
            out.append(res)
        return out

    def align_batch_arrays(self, batch: ReadBatch) -> dict:
        """Merged result dict in concatenated-genome coordinates."""
        return self._merge(batch,
                           self._finish_all(batch, self._dispatch_all(batch)))

    def _merge(self, batch: ReadBatch, results: list[dict]) -> dict:
        with tracing.collect(self.own_timings), tracing.span("merge"):
            n = batch.bases.shape[0]
            goff = np.cumsum([0] + [a.index.genome.total_length
                                    for a in self.aligners[:-1]])

            lp = np.stack([np.where(r["aligned"], r["log_prob"], -np.inf)
                           for r in results])                  # [G, B]
            # others_sum is exported exp(-log_scale)-scaled; recover the raw
            # mass in f64 (host math never underflows)
            others = np.stack([
                r["others_sum"].astype(np.float64)
                * np.exp(r.get("log_scale", np.zeros(n)).astype(np.float64))
                for r in results])
            best_g = np.argmax(lp, axis=0)
            any_aligned = np.isfinite(lp).any(axis=0)
            ar = np.arange(n)
            best_lp = lp[best_g, ar].astype(np.float64)
            exp_lp = np.where(np.isfinite(lp), np.exp(lp.astype(np.float64)),
                              0.0)
            others_total = others.sum(axis=0) + exp_lp.sum(axis=0) \
                - np.where(any_aligned, np.exp(best_lp), 0.0)

            rog = quality.rest_of_genome_correction(self.total_genome_length,
                                                    batch.read_len)
            safe_lp = np.where(any_aligned, best_lp, 0.0)
            mapq_f = quality.mapping_quality_f64(safe_lp, others_total, rog)
            cap = self.cfg.mapq_cap
            merged_mapq = np.clip(np.floor(mapq_f), 0, cap).astype(np.int32)

            out = {k: _pick_rows(results, k, best_g)
                   for k in ("reverse", "mismatches", "edit_distance",
                             "cigar")}
            # device-oriented output columns (orientation of the winning group
            # matches its own orient_rev, so the converter's fix-up is a no-op
            # unless downstream passes flip a row)
            for k in ("seq_out", "qual_out", "orient_rev"):
                v = _pick_rows(results, k, best_g)
                if v is not None:
                    out[k] = v
            out["aligned"] = any_aligned
            out["start"] = _pick_rows(results, "start", best_g) + goff[best_g]
            out["log_prob"] = best_lp
            out["others_sum"] = others_total
            # in-group gate (well-anchored / dodgy zeroing) wins over the
            # merged score
            in_group_mapq = _pick_rows(results, "mapq", best_g)
            out["mapq"] = np.where(in_group_mapq == 0, 0, merged_mapq)
            return out

    def align_results_many(self, batches):
        """(batch, merged result) pairs in batch order."""
        if self.group_major:
            yield from _group_major_many(
                self.aligners, batches,
                lambda a, b: a._finish(a._dispatch(b)),
                lambda a, b, r: a._record_stats(b, r),
                lambda b, rs: self._merge(b, rs))
            return
        for b in batches:
            yield b, self.align_batch_arrays(b)

    def align_to_sam(self, batch: ReadBatch,
                     phred_offset: int = 33) -> list[sam.SamRecord]:
        from ..build.records import to_sam_records
        from ..build.storage import from_single_result
        res = self.align_batch_arrays(batch)
        genome = self.combined_genome()
        fb = from_single_result(genome, batch, res, mapq_cap=self.cfg.mapq_cap)
        return to_sam_records(fb, genome.contigs)


@dataclasses.dataclass
class MultiIndexPairedAligner(_GroupsMixin):
    """Paired-end alignment across contig-group indexes.

    Per-group PairedAligner results merge vectorized on the host: the
    winning group is the one with the highest joint log-probability (pair
    lp when both ends aligned, single-end lp otherwise); the template
    score re-derives from the SUMMED cross-group pair-probability mass
    (resolve_pairs total_prob per group, align/pairs.py) and each end's
    mapping score from the summed end neighborhoods — the same math the
    reference runs per cluster (TemplateBuilder.cpp:233-286,435-447),
    re-associated across groups.
    """

    aligners: list[PairedAligner]
    group_major: bool = False

    @staticmethod
    def create(indexes: list[SeedIndex], read_len: int,
               group_major: bool = False, **opts
               ) -> "MultiIndexPairedAligner":
        _check_disjoint(indexes)
        return MultiIndexPairedAligner(
            _share_pool([PairedAligner.create(ix, read_len=read_len,
                                              defer_upload=group_major,
                                              **opts)
                         for ix in indexes]), group_major=group_major)

    @property
    def finder_stats(self):
        return _merged_finder_stats(self.aligners,
                                    getattr(self, "_anomalous", None))

    @property
    def sw_pairs(self) -> int:
        return self._summed("sw_pairs")

    @property
    def sw_accepted(self) -> int:
        return self._summed("sw_accepted")

    @property
    def rescue_rows(self) -> int:
        return self._summed("rescue_rows")

    @property
    def rescue_calls(self) -> int:
        return self._summed("rescue_calls")

    @property
    def tls(self):
        return self.aligners[0].tls

    @tls.setter
    def tls(self, value) -> None:
        for a in self.aligners:
            a.tls = value

    def learn_tls(self, batches):
        """Learn TLS on the largest group (insert-size statistics are a
        library property, not a genome-region one) and share it."""
        biggest = max(self.aligners,
                      key=lambda a: a.index.genome.total_length)
        biggest.ensure_uploaded()
        stats = biggest.learn_tls(batches)
        if self.group_major:
            biggest.release_device()
        self.tls = stats
        return stats

    def _dispatch_all(self, b1: ReadBatch, b2: ReadBatch) -> list:
        """Launch every group's paired device program, in group order,
        before fetching any (see MultiIndexAligner._dispatch_all)."""
        for a in self.aligners:
            a.ensure_uploaded()
        pending = [a._dispatch(b1, b2) for a in self.aligners]
        check_replay_order([a.graphs for a in self.aligners])
        return pending

    def _finish_all(self, b1: ReadBatch, b2: ReadBatch,
                    pendings: list) -> list[dict]:
        out = []
        for a, p in zip(self.aligners, pendings):
            res = a._finish(p)
            a._record_stats(b1, b2, res)
            out.append(res)
        return out

    def align_batch_arrays(self, b1: ReadBatch, b2: ReadBatch) -> dict:
        """Merged paired result dict in concatenated-genome coordinates."""
        return self._merge(
            b1, b2, self._finish_all(b1, b2, self._dispatch_all(b1, b2)))

    def _merge(self, b1: ReadBatch, b2: ReadBatch, results: list[dict]) -> dict:
        with tracing.collect(self.own_timings), tracing.span("merge"):
            n = b1.bases.shape[0]
            ar = np.arange(n)
            goff = np.cumsum([0] + [a.index.genome.total_length
                                    for a in self.aligners[:-1]])
            neg_inf = -np.inf

            def joint_lp(r):
                a1, a2 = r["aligned_1"], r["aligned_2"]
                lp1 = np.where(a1, r["log_prob_1"], 0.0)
                lp2 = np.where(a2, r["log_prob_2"], 0.0)
                return np.where(a1 | a2, lp1 + lp2, neg_inf)

            jl = np.stack([joint_lp(r) for r in results])          # [G, B]
            best_g = np.argmax(jl, axis=0)

            g_total = self.total_genome_length
            read_lens = (b1.read_len, b2.read_len)
            rog_t = quality.rest_of_genome_correction(g_total, sum(read_lens))
            cap = self.cfg.mapq_cap

            out = {}
            keys = ["proper_pair", "pair_resolved", "template_length",
                    "pair_best_lp"]
            for e in (1, 2):
                keys += [f"aligned_{e}", f"reverse_{e}", f"mismatches_{e}",
                         f"edit_distance_{e}", f"cigar_{e}", f"log_prob_{e}",
                         f"shadow_{e}", f"seq_out_{e}", f"qual_out_{e}",
                         f"orient_rev_{e}"]
            for k in keys:
                v = _pick_rows(results, k, best_g)
                if v is not None:
                    out[k] = v
            for e in (1, 2):
                out[f"start_{e}"] = _pick_rows(results, f"start_{e}", best_g) \
                    + np.where(out[f"aligned_{e}"], goff[best_g], 0)

            # merged template score over the summed cross-group pair mass
            # (exported exp(-pair_log_scale)-scaled; recover raw in f64)
            pair_total = np.stack([
                r["pair_total_prob"].astype(np.float64)
                * np.exp(r["pair_log_scale"].astype(np.float64))
                for r in results]).sum(0)
            resolved = out["pair_resolved"].astype(bool)
            p_best = np.exp(out["pair_best_lp"].astype(np.float64))
            others = np.maximum(pair_total - p_best, 0.0) + rog_t
            denom = pair_total + rog_t
            with np.errstate(divide="ignore", invalid="ignore"):
                ts = np.floor(-10.0 * np.log10(
                    np.where(resolved, others / np.maximum(denom, 1e-300),
                             1.0)))
            in_group_ts = _pick_rows(results, "template_score", best_g)
            out["template_score"] = np.where(
                resolved & (in_group_ts >= 0),
                np.clip(ts, -1, cap).astype(np.int64), in_group_ts)
            out["pair_total_prob"] = pair_total

            # merged per-end mapping scores over the summed end neighborhoods
            rogs = [quality.rest_of_genome_correction(g_total, l)
                    for l in read_lens]
            for e_idx, e in enumerate((1, 2)):
                o = np.stack([
                    r[f"others_sum_{e}"].astype(np.float64)
                    * np.exp(r[f"log_scale_{e}"].astype(np.float64))
                    for r in results])
                lp = np.stack([np.where(r[f"aligned_{e}"], r[f"log_prob_{e}"],
                                        neg_inf) for r in results]
                              ).astype(np.float64)
                exp_lp = np.where(np.isfinite(lp), np.exp(lp), 0.0)
                best_lp = lp[best_g, ar]
                aligned = out[f"aligned_{e}"].astype(bool)
                others_total = o.sum(0) + exp_lp.sum(0) \
                    - np.where(aligned, np.exp(best_lp), 0.0)
                mq = quality.mapping_quality_f64(
                    np.where(aligned, best_lp, 0.0),
                    np.maximum(others_total, 0.0), rogs[e_idx])
                merged = np.clip(np.floor(mq), 0, cap).astype(np.int64)
                in_group = _pick_rows(results, f"frag_score_{e}", best_g)
                # in-group gate (dodgy / not well-anchored -> 0) wins
                out[f"frag_score_{e}"] = np.where(
                    aligned & (in_group > 0), merged, in_group)
            # disjoined recomputes from the MERGED state (both ends aligned
            # across any groups, no pair) so the host disjoined rescue runs
            out["disjoined"] = (out["aligned_1"].astype(bool)
                                & out["aligned_2"].astype(bool)
                                & ~out["pair_resolved"].astype(bool))
            # anomalous accounting happens on the MERGED template (per-group
            # counts would tally one template once per group it aligns in)
            both = (out["aligned_1"].astype(bool)
                    & out["aligned_2"].astype(bool))
            self._anomalous = getattr(self, "_anomalous", 0) + int(
                (both & ~out["proper_pair"].astype(bool)).sum())
            return out

    def align_results_many(self, batches):
        """((b1, b2), merged result) pairs in batch order (see
        MultiIndexAligner.align_results_many)."""
        if self.group_major:
            yield from _group_major_many(
                self.aligners, batches,
                lambda a, bb: a._finish(a._dispatch(bb[0], bb[1])),
                lambda a, bb, r: a._record_stats(bb[0], bb[1], r),
                lambda bb, rs: self._merge(bb[0], bb[1], rs))
            return
        for b1, b2 in batches:
            yield (b1, b2), self.align_batch_arrays(b1, b2)

    def align_to_sam(self, b1: ReadBatch, b2: ReadBatch,
                     phred_offset: int = 33) -> list[sam.SamRecord]:
        from ..build.records import to_sam_records
        from ..build.storage import from_paired_result
        res = self.align_batch_arrays(b1, b2)
        genome = self.combined_genome()
        fb = from_paired_result(
            genome, b1, b2, res, mapq_cap=self.cfg.mapq_cap,
            pessimistic=getattr(self.aligners[0], "pessimistic_mapq", False))
        return to_sam_records(fb, genome.contigs)
