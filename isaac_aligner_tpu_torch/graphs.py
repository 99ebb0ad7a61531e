"""Replays of a batch's fixed-shape device program as CUDA graphs.

The device program of a batch (`Aligner._dispatch`: tail mask and
`align_batch`; `PairedAligner._dispatch`: both ends' tail masks and
`align_paired_batch`) is thousands of small torch ops whose shapes follow
the batch's shapes alone and which never sync with the host
(`align/pipeline.py`).  Enqueued eagerly, the host's launch cost sets its
time; `ProgramGraphs.run` captures it once as a CUDA graph and replays it,
one launch, for every later batch with the same key.

The policy follows what the batch shows, never a switch:

- on a device other than CUDA the program runs eagerly;
- the key is the caller's (the `AlignConfig` and the TLS model the program
  bakes in as Python values) plus every input's shape and dtype;
- a key's first sight runs eagerly, its second warms up on a side stream,
  captures and replays, every later sight replays.  A job's odd last batch
  or a TLS hint seen once never pays for a capture;
- at most `KEEP` keys are kept; the least recently used goes, with its
  graph;
- graphs read the index planes at the addresses they were captured with:
  `clear()` drops them (`release_device`), and a run over other planes
  drops them too.

A replay's outputs are the graph's own tensors, overwritten by its next
replay: every caller fetches a dispatch's results before it dispatches the
same aligner again (`Aligner.align_batch_arrays`, `PairedAligner.
align_batch_arrays`, the multi-index drivers' `_finish_all` and their
group-major loop).  The contig groups of a multi-index driver share one
memory pool (`GraphPool`): they are captured and replayed in group order,
and a later group's graph may hold its outputs where an earlier group's
temporaries were, so one program's transient memory serves them all, as
it does eagerly.  That is safe while a round of dispatches replays the
groups' graphs in the order they were captured: a graph replayed later in
the round was captured while the earlier ones' outputs were held, and its
temporaries never lie where those outputs wait for their fetch.  Every
group sees the same keys at the same batches, so the order holds;
`check_replay_order` raises before the fetch if it ever does not.

The pool's memory stays held between replays: the polish and the rescue
allocate beside it, not in it, and `torch.cuda.max_memory_allocated`
counts a replay's temporaries only at the capture
(`scripts/torch_working_set.py` reads the pool too).
"""

from __future__ import annotations

import collections
import itertools
import weakref

import numpy as np
import torch

from .utils import tracing

#: keys kept per aligner: a run's batch shape, a partial last batch and a
#: TLS model or two
KEEP = 4

#: numbers the captures in the order they were made (`check_replay_order`)
_CAPTURES = itertools.count()


class GraphPool:
    """One CUDA graph memory pool, made at the first capture; the
    multi-index drivers give their groups' `ProgramGraphs` the same one."""

    def __init__(self):
        self.handle = None

    def get(self):
        if self.handle is None:
            self.handle = torch.cuda.graph_pool_handle()
        return self.handle


def upload(x: np.ndarray, device) -> torch.Tensor:
    """A host array on `device` (the eager path's inputs)."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _torch_dtype(x: np.ndarray) -> torch.dtype:
    return torch.from_numpy(np.empty(0, x.dtype)).dtype


class _Captured:
    """One key's graph: its static inputs on the card, their pinned host
    staging, and the output dict the capture returned."""

    def __init__(self, inputs, device: torch.device):
        self.device = device
        self.static = [torch.empty(x.shape, dtype=_torch_dtype(x),
                                   device=device) for x in inputs]
        self.staging = [torch.empty(x.shape, dtype=_torch_dtype(x),
                                    pin_memory=True) for x in inputs]
        # recorded after each copy-in: the staging buffers are free again
        # once it has passed
        self.copied = torch.cuda.Event()
        self.graph = None
        self.outputs = None

    def load(self, inputs) -> None:
        """The batch's host arrays into the static inputs, through the
        pinned staging, on the current stream."""
        self.copied.synchronize()
        for h, s, x in zip(self.staging, self.static, inputs):
            np.copyto(h.numpy(), x)
            s.copy_(h, non_blocking=True)
        self.copied.record()

    def capture(self, program, pool: GraphPool) -> None:
        """Warm up on a side stream, then capture the program on the
        static inputs."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            program(*self.static)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool.get(),
                              capture_error_mode="thread_local"):
            outputs = program(*self.static)
        self.graph, self.outputs = graph, outputs


class ProgramGraphs:
    """A driver's captured device programs, by key (module docstring)."""

    def __init__(self):
        # the multi-index drivers set one pool for all their groups
        self.pool = GraphPool()
        # key -> None (seen once) or its _Captured, least recent first
        self._keys: collections.OrderedDict = collections.OrderedDict()
        self._planes = None
        # the capture number of the graph the last `run` replayed, None
        # where it ran eagerly
        self.last = None

    def __len__(self) -> int:
        return sum(v is not None for v in self._keys.values())

    def clear(self) -> None:
        """Drop every key and graph (the planes they read are going)."""
        self._keys.clear()
        self._planes = None

    def run(self, key, program, inputs, device: torch.device, planes,
            tally) -> dict:
        """`program(*device_inputs)` -> its output dict, for the host
        arrays `inputs`: eagerly, or captured and replayed (module
        docstring).  `planes` is the index arrays the program reads; the
        path taken adds one to `tally`'s `eager_dispatches`,
        `graph_captures` or `graph_replays`."""
        self.last = None
        if device.type != "cuda":
            tally.eager_dispatches += 1
            return program(*[upload(x, device) for x in inputs])
        if self._planes is None or self._planes() is not planes:
            self.clear()
            self._planes = weakref.ref(planes)
        key = (key, tuple((x.shape, x.dtype.str) for x in inputs))
        if key not in self._keys:
            self._keys[key] = None
            while len(self._keys) > KEEP:
                self._keys.popitem(last=False)
            tally.eager_dispatches += 1
            return program(*[upload(x, device) for x in inputs])
        self._keys.move_to_end(key)
        entry = self._keys[key]
        if entry is None:
            with tracing.span("device.capture"):
                entry = _Captured(inputs, device)
                entry.load(inputs)
                entry.capture(program, self.pool)
                entry.graph.replay()
            entry.seq = next(_CAPTURES)
            self._keys[key] = entry
            tally.graph_captures += 1
        else:
            with tracing.span("device.graph"):
                entry.load(inputs)
                entry.graph.replay()
            tally.graph_replays += 1
        self.last = entry.seq
        return dict(entry.outputs)


def check_replay_order(programs) -> None:
    """Raise unless the graphs that one round of the groups' dispatches
    replayed (each group's `ProgramGraphs.last`, in dispatch order) were
    captured in that order: in the pool they share, a graph captured
    earlier but replayed later may write its temporaries where a later
    capture's outputs wait for their fetch (module docstring)."""
    seqs = [p.last for p in programs if p.last is not None]
    if seqs != sorted(seqs):
        raise RuntimeError(
            f"contig groups replayed graphs out of capture order {seqs}: "
            "their shared pool would overwrite an earlier group's outputs")
