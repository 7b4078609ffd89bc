"""Native (C++) host code of the port, compiled with g++ at first use.

  eventlog.cpp  the append-only event journal (CRC-framed, flock-safe)
                under the PEVLOG and EVLOG storage drivers; a copy of
                `predictionio_tpu/native/eventlog.cpp`, the same frame
                format byte for byte

`load(name)` compiles `<name>.cpp` into `predictionio_tpu_torch/_build/`
(git-ignored) and returns a ctypes handle, or None when there is no
compiler: `native.eventlog` then frames in Python, in the same format.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
_lock = threading.Lock()
_cache: Dict[str, Optional[ctypes.CDLL]] = {}


def load(name: str) -> Optional[ctypes.CDLL]:
    """Compile (if stale) and dlopen native/<name>.cpp; None on failure.
    The build writes a temporary file and renames it into place, so
    processes that build at once never load a half-written library."""
    with _lock:
        if name in _cache:
            return _cache[name]
        src = _DIR / f"{name}.cpp"
        so = BUILD_DIR / f"lib{name}.so"
        lib = None
        try:
            if (not so.exists()
                    or so.stat().st_mtime < src.stat().st_mtime):
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp),
                     str(src)],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.SubprocessError):
            lib = None
        _cache[name] = lib
        return lib
