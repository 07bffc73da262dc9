"""Build of the port's host library (``csrc/*.cpp``: the BGZF/BAM engine,
the packers, the host greedy and the host MCMF).

Compiled with ``g++`` at first use, or when a source is newer than the
library, into ``build/gd_host/`` at the repository root (git-ignored).
Several processes may ask at once (test workers): the build holds an
exclusive lock on ``build/gd_host/lock`` and re-checks under it, so one
``g++`` runs per tree, and it writes under a private name and renames, so
no process ever loads a half-written library.

``GD_HOST_SO`` names a prebuilt library to load instead, with no check and
no build: ``scripts/run_asan.sh`` points it at an AddressSanitizer build.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
from pathlib import Path

_CSRC = Path(__file__).parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gd_host"
_SO = _BUILD_DIR / "libgd_host.so"


class NativeBuildError(OSError):
    """g++ failed on the host library's sources."""


def _fresh(so: Path) -> bool:
    newest = max(s.stat().st_mtime for s in _CSRC.glob("*.cpp"))
    return so.exists() and so.stat().st_mtime >= newest


def build_bamio(force: bool = False) -> Path:
    """Path of the host library, compiling it first if it is missing or
    older than a source; the path ``GD_HOST_SO`` names, if it is set."""
    override = os.environ.get("GD_HOST_SO")
    if override:
        return Path(override)
    if not force and _fresh(_SO):
        return _SO
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and _fresh(_SO):  # another process built it meanwhile
            return _SO
        tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
        cmd = [
            "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
            *map(str, sorted(_CSRC.glob("*.cpp"))), "-o", str(tmp),
            "-lz", "-lpthread",
        ]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise NativeBuildError(f"host library build failed:\n{proc.stderr}")
            os.replace(tmp, _SO)
        finally:
            tmp.unlink(missing_ok=True)
    return _SO
