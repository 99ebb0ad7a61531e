"""Native (C++) host helpers of the output path, loaded via ctypes.

The port's own copies of `isaac_aligner_tpu/native/`: BGZF compression
(`bgzf.cpp`), BAM record-core assembly (`bamrec.cpp`) and row scatters
(`scatter.cpp`).  Each degrades to a pure-Python fallback with the same
bytes when the shared library cannot be built.
"""

from .build import load_library  # noqa: F401
