"""Typed exception hierarchy + process entry wrapper.

The port's own copy of `isaac_aligner_tpu/utils/errors.py`, unchanged.

Reference analog: common::Exceptions / common::Program
(src/c++/include/common/Exceptions.hh — IoException, MemoryException,
PreConditionException, InvalidOptionException, InvalidParameterException —
and the common::run(main) wrapper in include/common/Program.hh that maps
exception classes to exit codes and a diagnosable stderr line).
"""

from __future__ import annotations

import sys


class IsaacError(Exception):
    """Base of all typed framework errors; `exit_code` drives run()."""

    exit_code = 1


class IoError(IsaacError):
    """File/format trouble (reference IoException): missing inputs,
    malformed FASTA/FASTQ/BCL/BAM, truncated temp artifacts."""

    exit_code = 2


class InvalidOptionError(IsaacError):
    """Bad command-line usage (reference InvalidOptionException)."""

    exit_code = 3


class PreConditionError(IsaacError):
    """Caller violated an API contract (reference PreConditionException)."""

    exit_code = 4


class MemoryError_(IsaacError):
    """A memory budget cannot be met (reference MemoryException)."""

    exit_code = 5


def run(main, argv=None) -> int:
    """Execute a CLI main() mapping typed errors to exit codes + one
    clean stderr line (the reference's common::run catches, prints the
    exception type + what(), and exits non-zero instead of tracebacking).

    Untyped ValueError/OSError map to exit 2 like IoException — they are
    overwhelmingly bad inputs/flags in this codebase — but the full
    traceback is preserved: printed when ISAAC_TPU_TRACEBACK=1 and
    always mentioned so field failures stay diagnosable."""
    import os
    import traceback
    try:
        return int(main(argv) or 0)
    except IsaacError as e:
        print(f"{type(e).__name__}: {e}", file=sys.stderr)
        return e.exit_code
    except (ValueError, FileNotFoundError, OSError) as e:
        if os.environ.get("ISAAC_TPU_TRACEBACK"):
            traceback.print_exc()
        else:
            print(f"{type(e).__name__}: {e}\n"
                  f"(set ISAAC_TPU_TRACEBACK=1 for the full traceback)",
                  file=sys.stderr)
        return 2
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130
