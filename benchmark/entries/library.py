"""The `library` entry: the program's paired aligner library
(`PairedAligner`, or `MultiIndexPairedAligner` for a grouped reference)
over batches parsed in set-up, in a closed loop with one client.

Set-up loads the configuration's index onto the card, learns the TLS from
the first batches as the workflow does, and aligns every batch once; the
window then runs `align_results_many` over the batches in turn until
`--seconds` have passed, each batch's result arrays on the host when it
counts, and counts all reads over all the time.  The rows the check will
judge are drawn from the seed before the window and kept as each batch
comes back, with the candidate lists the reference follows.
"""

from __future__ import annotations

import collections
import itertools
import time

import numpy as np

import program
from entries import checks
from reference.judge import make_judge

KEYS = ("aligned", "start", "reverse", "edit_distance", "frag_score",
        "log_prob")


class Library:
    def __init__(self, ctx):
        self.ctx = ctx
        lib, t = ctx.library, ctx.traffic
        size = int(t["batch_pairs"])
        self.batches = []
        for first in range(0, lib.pairs, size):
            sl = slice(first, first + size)
            self.batches.append(tuple(
                program.read_batch(lib.bases[e, sl], lib.quals[e, sl], first)
                for e in (0, 1)))
        self.aligner = program.paired_aligner(
            program.load_indexes(ctx.index_path), lib.read_len, ctx.device,
            **ctx.config.get("options", {}))
        tls = t["tls"]
        learn = [tuple(program.read_batch(
            lib.bases[e, k * tls["batch"]:(k + 1) * tls["batch"]],
            lib.quals[e, k * tls["batch"]:(k + 1) * tls["batch"]],
            k * tls["batch"]) for e in (0, 1)) for k in range(tls["batches"])]
        self.aligner.learn_tls(learn)
        for _ in self.aligner.align_results_many(self.batches):
            pass
        self.kept: list[tuple[int, dict]] = []
        self.rows = None
        self.cands: dict = {}

    def choose_rows(self, rng: np.random.Generator, per_batch: int) -> None:
        """The rows of each batch that the check will judge."""
        self.rows = [np.sort(rng.choice(b1.count, min(per_batch, b1.count),
                                        replace=False))
                     for b1, _b2 in self.batches]
        size = int(self.ctx.traffic["batch_pairs"])
        self.templates = np.concatenate(
            [k * size + r for k, r in enumerate(self.rows)])

    def window(self, seconds: float) -> dict:
        """Batches in turn until `seconds` have passed, keeping the chosen
        rows of each batch's results."""
        self.timings0 = dict(self.aligner.timings)
        self.sw0 = self.aligner.sw_pairs
        fed: collections.deque = collections.deque()

        def feed():
            for k in itertools.cycle(range(len(self.batches))):
                fed.append(k)
                yield self.batches[k]

        units, reads = 0, 0
        with program.candidates_kept(self.cands, self.templates):
            t0 = time.perf_counter()
            for (b1, _b2), res in self.aligner.align_results_many(feed()):
                units += 1
                reads += 2 * b1.count
                self._keep(fed.popleft(), res)
                if time.perf_counter() - t0 >= seconds:
                    break
            elapsed = time.perf_counter() - t0
        return {"units": units, "reads": reads, "elapsed": elapsed,
                "record": self._record(reads)}

    def _keep(self, k: int, res: dict) -> None:
        rows = self.rows[k]
        kept = {"n": len(res["aligned_1"]),
                "proper": np.asarray(res["proper_pair"])[rows].astype(bool)}
        for e in ("_1", "_2"):
            for key in KEYS:
                kept[key + e] = np.asarray(res[key + e])[rows]
            cig = res.get("cigar" + e)
            kept["cigar" + e] = [cig[r] if cig is not None else None
                                 for r in rows]
        first = k * int(self.ctx.traffic["batch_pairs"])
        kept["cands"] = {key: v for key, v in self.cands.items()
                         if key[1] == first}
        self.kept.append((k, kept))

    def _record(self, reads: int) -> dict:
        t = self.aligner.timings
        stage = {key: t.get(key, 0.0) - self.timings0.get(key, 0.0)
                 for key in t}
        return {"entry": "library", "reads": reads, "stage_seconds": stage,
                "sw_pairs": self.aligner.sw_pairs - self.sw0}

    def traced(self) -> dict:
        """Every batch once more, for the device trace."""
        t0 = time.perf_counter()
        for _ in self.aligner.align_results_many(self.batches):
            pass
        return {"wall": time.perf_counter() - t0}

    def release(self) -> None:
        self.aligner = None

    def check(self, rng: np.random.Generator, sample: int) -> dict:
        """The reference's numbers over the kept rows of every batch the
        window ran.  A unit whose kept answers equal an earlier unit's of
        the same batch has that unit's verdict."""
        ctx, lib = self.ctx, self.ctx.library
        judge = checks.Pairs(ctx, make_judge(ctx))
        size = int(ctx.traffic["batch_pairs"])
        tally = checks.Tally()
        seen: dict[int, list] = {}
        bad_units = 0
        for k, kept in self.kept:
            first = k * size
            missing = abs(kept["n"] - min(size, lib.pairs - first))
            verdict = next((v for old, v in seen.get(k, [])
                            if checks.same_answers(old, kept)), None)
            if verdict is None:
                verdict = checks.Tally()
                ends = [{key: kept[key + sfx] for key in KEYS + ("cigar",)}
                        for sfx in ("_1", "_2")]
                judge.rows(verdict, first + self.rows[k], ends,
                           kept["proper"], judge.by_template(kept["cands"]))
                seen.setdefault(k, []).append((kept, verdict))
            tally.add(verdict)
            tally.counts["missing"] += missing
            bad_units += int(missing > 0 or verdict.bad())
        out = tally.numbers()
        out["_bad_units"] = bad_units
        return out
