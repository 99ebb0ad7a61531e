"""isaac_aligner_tpu_torch — the aligner's FASTQ paths in PyTorch + CUDA.

A port of `isaac_aligner_tpu` (JAX/XLA + one Pallas kernel) to PyTorch on
an NVIDIA Hopper GPU.  The JAX package stays the reference: every module
here names its counterpart, and the tests hold each against it on the same
inputs.

- The slice is the workflow users run, single-device, single-end and
  paired-end: FASTQ (pairs) -> `workflow.align.AlignWorkflow` (or `python
  -m isaac_aligner_tpu_torch align`) -> sorted, duplicate-marked,
  gap-realigned BAM with .bai and .md5, byte-equal to the JAX workflow's.
  Its library halves are `aligner.Aligner` and `aligner.PairedAligner`.
- Device code is plain torch ops on tensors, with one hand-written CUDA
  kernel: the banded Smith-Waterman of the gapped polish
  (`ops/csrc/banded_sw.cu`, built with nvcc on first use).
- Entry points run on the card unless the caller asks for the CPU
  ("cuda" is the default device; without a card it raises, never falls
  back: `device.require_device`).  On CPU tensors each kernel wrapper runs
  its plain torch version, which is what the CPU tests exercise.
- The host modules are the port's own copies of the JAX package's, under
  the same module names and unchanged in behaviour (`dna`, `io.*`,
  `index.build`, `align.{clippers,tls}`, `build.*`, `workflow.{output_proc,
  stats_agg,reports}`, `utils.*`, `native/*.cpp`).  This package imports
  neither jax nor anything of `isaac_aligner_tpu`, and this file imports
  no torch: the workflow's spawned output process imports only host
  modules.
"""

__version__ = "0.1.0"
