"""Template-length statistics (insert-size model) for paired-end data.

Reference parity: alignment/TemplateLengthStatistics
(src/c++/include/alignment/TemplateLengthStatistics.hh,
 src/c++/lib/alignment/TemplateLengthStatistics.cpp).

Semantics reproduced exactly:
- 8 alignment models FFp..RRm encoded as (posMask<<2 | f1Reverse<<1 |
  f2Reverse) where posMask = f1.pos > f2.pos (hh:153-162).
- template length = max(rightmost end - leftmost start, leftmost observed
  length) (hh:166-177).
- learning (TemplateLengthDistribution::addTemplate/updateStatistics,
  cpp:104-400): only templates where BOTH ends have exactly one candidate,
  same contig, length <= 50000 enter the per-model histograms; the two
  best models by count are kept; min/median/max are the erf(3/sqrt2)
  two-sided quantiles of the combined best-two histogram and the 1-sigma
  quantiles give low/high std devs; stability = statistics unchanged
  after an UPDATE_FREQUENCY=10000 re-estimate.
- matchModel: length <= max + TEMPLATE_LENGTH_THRESHOLD and model in the
  best two (cpp:67-77); checkModel returns Nominal only when
  min <= len <= max (hh:104-118).
- mate search window: mateMin/MaxPosition (cpp:201-240).

The learner is host-side numpy (it consumes small per-batch summaries);
the model's check/length math also exists as tensor helpers used by the
pair resolver (`align/pairs.py`).

The port's own copy of `isaac_aligner_tpu/align/tls.py`, unchanged in
behaviour.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

TEMPLATE_LENGTH_THRESHOLD = 50_000
UPDATE_FREQUENCY = 10_000
_CI_3Z = math.erf(3.0 / math.sqrt(2.0))
_CI_1Z = math.erf(1.0 / math.sqrt(2.0))
LOWER_PERCENT = (1.0 - _CI_3Z) / 2.0
UPPER_PERCENT = (1.0 + _CI_3Z) / 2.0
LOWER_PERCENT_1Z = (1.0 - _CI_1Z) / 2.0
UPPER_PERCENT_1Z = (1.0 + _CI_1Z) / 2.0

# model ids
FFp, FRp, RFp, RRp, FFm, FRm, RFm, RRm = range(8)
INVALID_MODEL = 8


def alignment_model(f1_pos, f1_rev, f2_pos, f2_rev):
    """Vectorizable model id; caller guarantees same contig."""
    pos_mask = np.where(np.asarray(f1_pos) <= np.asarray(f2_pos), 0, 4)
    return pos_mask | (np.asarray(f1_rev).astype(np.int32) << 1) | \
        np.asarray(f2_rev).astype(np.int32)


def template_length(f1_pos, f1_len, f2_pos, f2_len):
    """Vectorizable reference getLength (hh:166-177)."""
    f1_pos = np.asarray(f1_pos)
    f2_pos = np.asarray(f2_pos)
    lo_first = f1_pos < f2_pos
    span1 = f2_pos + f2_len - f1_pos        # when f1 leftmost
    span2 = f1_pos + f1_len - f2_pos        # when f2 leftmost (or equal)
    return np.where(lo_first, np.maximum(span1, f1_len), np.maximum(span2, f2_len))


@dataclasses.dataclass
class TemplateLengthStatistics:
    min: int = 0
    max: int = TEMPLATE_LENGTH_THRESHOLD
    median: int = TEMPLATE_LENGTH_THRESHOLD // 2
    low_std_dev: int = 0
    high_std_dev: int = 0
    best_models: tuple[int, int] = (FRp, RFm)
    stable: bool = False
    # mate drift defaults to min/max window (reference --mate-drift-range -1)
    mate_min: int = 0
    mate_max: int = TEMPLATE_LENGTH_THRESHOLD

    def match_model(self, model, length):
        """Loose pair filter (cpp:67-77); vectorizable."""
        in_models = (np.asarray(model) == self.best_models[0]) | \
                    (np.asarray(model) == self.best_models[1])
        return in_models & (np.asarray(length) <= self.max + TEMPLATE_LENGTH_THRESHOLD)

    def nominal(self, model, length):
        """checkModel == Nominal (proper pair)."""
        in_models = (np.asarray(model) == self.best_models[0]) | \
                    (np.asarray(model) == self.best_models[1])
        return in_models & (np.asarray(length) >= self.min) & \
            (np.asarray(length) <= self.max)

    # -- mate window (cpp:186-240) -----------------------------------------

    def _is_valid_model(self, reverse: bool, read_index: int) -> bool:
        shift = 1 - read_index
        return any(((m >> shift) & 1) == int(reverse) for m in self.best_models)

    def _first_fragment(self, reverse: bool, read_index: int) -> bool:
        """True when this (readIndex, orientation) end is the leftmost one
        under the first best model that matches its orientation."""
        shift = 1 - read_index
        for m in self.best_models:
            if ((m >> shift) & 1) == int(reverse):
                # position bit: 0 => read 'readIndex==0 side' leftmost...
                # reference firstFragment: model < 4 means f1 <= f2
                return (m < 4) == (read_index == 0)
        return (self.best_models[0] < 4) == (read_index == 0)

    def mate_orientation(self, read_index: int, reverse: bool) -> bool:
        shift = 1 - read_index
        for m in self.best_models:
            if ((m >> shift) & 1) == int(reverse):
                return bool((m >> read_index) & 1)
        return bool((self.best_models[0] >> read_index) & 1)

    def mate_min_position(self, read_index: int, reverse: bool, position: int,
                          read_lengths: tuple[int, int]) -> int:
        if not self._is_valid_model(reverse, read_index):
            return position
        if self._first_fragment(reverse, read_index):
            return position + self.mate_min - read_lengths[1 - read_index]
        return position - self.mate_max + read_lengths[read_index]

    def mate_max_position(self, read_index: int, reverse: bool, position: int,
                          read_lengths: tuple[int, int]) -> int:
        if not self._is_valid_model(reverse, read_index):
            return position
        if self._first_fragment(reverse, read_index):
            return position + self.mate_max - read_lengths[1 - read_index]
        return position - self.mate_min + read_lengths[read_index]


class TemplateLengthLearner:
    """Streaming TLS estimation (TemplateLengthDistribution, cpp:275-400)."""

    def __init__(self) -> None:
        self.histograms: list[list[int]] = [[] for _ in range(8)]
        self.count = 0
        self.stats = TemplateLengthStatistics()
        self._last: tuple | None = None

    def add_batch(self, f1_pos, f1_rev, f1_len, f2_pos, f2_rev, f2_len, use_mask):
        """Add uniquely-aligned same-contig pairs from one batch.

        All args are [B] numpy arrays; `use_mask` selects rows where both
        ends aligned uniquely on the same contig (caller computes it).
        """
        f1_pos = np.asarray(f1_pos)[use_mask]
        f2_pos = np.asarray(f2_pos)[use_mask]
        f1_rev = np.asarray(f1_rev)[use_mask]
        f2_rev = np.asarray(f2_rev)[use_mask]
        f1_len = np.asarray(f1_len)[use_mask] if np.ndim(f1_len) else f1_len
        f2_len = np.asarray(f2_len)[use_mask] if np.ndim(f2_len) else f2_len
        lengths = template_length(f1_pos, f1_len, f2_pos, f2_len)
        models = alignment_model(f1_pos, f1_rev, f2_pos, f2_rev)
        ok = lengths <= TEMPLATE_LENGTH_THRESHOLD
        for m, l in zip(models[ok], np.asarray(lengths)[ok]):
            self.histograms[int(m)].append(int(l))
            self.count += 1
            if self.count % UPDATE_FREQUENCY == 0:
                self._update()
        return self.stats.stable

    def _update(self) -> None:
        sizes = [len(h) for h in self.histograms]
        # two best models by histogram size (ties resolved like the
        # reference's sequential scan, cpp:108-122)
        best0 = FFp if sizes[FRp] <= sizes[FFp] else FRp
        best1 = (best0 + 1) % 2
        for i in range(2, 8):
            if sizes[i] > sizes[best0]:
                best1 = best0
                best0 = i
            elif sizes[i] > sizes[best1]:
                best1 = i
        lengths = np.sort(np.array(self.histograms[best0] + self.histograms[best1],
                                   dtype=np.int64))
        s = self.stats
        if lengths.size == 0:
            new = TemplateLengthStatistics(
                min=0, max=TEMPLATE_LENGTH_THRESHOLD,
                median=TEMPLATE_LENGTH_THRESHOLD // 2,
                low_std_dev=TEMPLATE_LENGTH_THRESHOLD // 2,
                high_std_dev=TEMPLATE_LENGTH_THRESHOLD // 2,
                best_models=(best0, best1))
        else:
            n = lengths.size
            mn = int(lengths[int(n * LOWER_PERCENT)])
            med = int(lengths[int(n * 0.5)])
            mx = int(lengths[min(n - 1, int(n * UPPER_PERCENT))])
            new = TemplateLengthStatistics(
                min=mn, max=mx, median=med,
                low_std_dev=med - int(lengths[int(n * LOWER_PERCENT_1Z)]),
                high_std_dev=int(lengths[min(n - 1, int(n * UPPER_PERCENT_1Z))]) - med,
                best_models=(best0, best1))
        new.mate_min, new.mate_max = new.min, new.max
        key = (new.min, new.max, new.median, new.low_std_dev, new.high_std_dev,
               new.best_models)
        prev_key = (s.min, s.max, s.median, s.low_std_dev, s.high_std_dev,
                    s.best_models)
        new.stable = key == prev_key
        self.stats = new

    def finalize(self) -> TemplateLengthStatistics:
        prev = self.stats
        self._update()
        self.stats.stable = self.stats.stable or (
            (prev.min, prev.max, prev.median) ==
            (self.stats.min, self.stats.max, self.stats.median))
        return self.stats
