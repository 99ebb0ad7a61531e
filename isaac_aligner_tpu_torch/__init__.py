"""isaac_aligner_tpu_torch — the aligner's single-end path in PyTorch + CUDA.

A port of `isaac_aligner_tpu` (JAX/XLA + one Pallas kernel) to PyTorch on
an NVIDIA Hopper GPU.  The JAX package stays the reference: every module
here names its counterpart, and the tests hold each against it on the same
inputs.

- Device code is plain torch ops on tensors, with one hand-written CUDA
  kernel: the banded Smith-Waterman of the gapped polish
  (`ops/csrc/banded_sw.cu`, built with nvcc on first use).
- Every function that touches a device takes it explicitly; asking for
  "cuda" without a card raises (`device.require_device`).  On CPU tensors
  each kernel wrapper runs its plain torch version, which is what the CPU
  tests exercise.
- The host modules are the port's own copies of the JAX package's, under
  the same module names and unchanged in behaviour: `dna`, `io.fasta`,
  `io.fastq`, `io.sam`, `io.bam` (`parse_cigar`), `index.build` (with
  `SeedIndex.save`/`load` on the same on-disk layout, so an index
  directory written by either package loads in the other),
  `align.clippers` and `utils.tracing`.  This package imports neither jax
  nor anything of `isaac_aligner_tpu`.
"""

__version__ = "0.1.0"
