"""Build-on-first-use for the native host helpers (g++ -> .so, ctypes).

The port's own copy of `isaac_aligner_tpu/native/build.py`: it compiles
the port's copies of the C++ sources in this directory (`bgzf.cpp`,
`bamrec.cpp`, `scatter.cpp`) into the git-ignored `_build/` beside them,
never the JAX package's shared objects.  A missing toolchain leaves each
caller on its pure-Python/numpy fallback, which writes the same bytes;
`loaded()` says which libraries are native in this process.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

_DIR = Path(__file__).parent
_BUILD = _DIR / "_build"
_CACHE: dict[str, ctypes.CDLL | None] = {}

_LINK_FLAGS = {
    "bgzf": ["-lz", "-lpthread"],
    "bamrec": ["-lpthread"],
}

#: the native libraries of the output path
LIBRARIES = ("bgzf", "bamrec", "scatter")


def load_library(name: str) -> ctypes.CDLL | None:
    """Compile (if stale) and load lib<name>.so; None if the build fails."""
    if name in _CACHE:
        return _CACHE[name]
    src = _DIR / f"{name}.cpp"
    so = _BUILD / f"lib{name}.so"
    lib: ctypes.CDLL | None = None
    try:
        if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
            _BUILD.mkdir(exist_ok=True)
            # build under a per-process name, then rename: processes that
            # start together (test workers, the output process) never load
            # a half-written file
            tmp = _BUILD / f".lib{name}.{os.getpid()}.so"
            cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                   str(src), "-o", str(tmp)] + _LINK_FLAGS.get(name, [])
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError):
        lib = None
    _CACHE[name] = lib
    return lib


def loaded() -> dict[str, bool]:
    """{library: True when its native build loaded} for `LIBRARIES`."""
    return {name: load_library(name) is not None for name in LIBRARIES}
