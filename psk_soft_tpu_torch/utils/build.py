"""Build-at-first-use for the port's native libraries.

Each library is compiled from its source in the checkout into
``build/psk_soft_tpu_torch/`` (git-ignored), under a file name keyed by a
hash of the source, the headers it includes and the compile command, so an
edited source, header or flag rebuilds and a stale library is never loaded.  The compiler writes to a
temporary name that is renamed into place, so concurrent builds (test
workers) never load a half-written file.  Builds of different libraries in
one process run in parallel (one lock per library name).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build" / "psk_soft_tpu_torch"

_locks: dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def _lock_for(name: str) -> threading.Lock:
    with _locks_guard:
        return _locks.setdefault(name, threading.Lock())


def build_shared(source: Path, name: str, compiler: list[str],
                 flags: list[str],
                 headers: tuple[Path, ...] = ()) -> tuple[Path, str]:
    """Compile ``source`` (which includes ``headers``) into a shared
    library unless an up-to-date one exists.  Returns (library path,
    compiler output of this build or "")."""
    key = hashlib.sha256(b"".join(p.read_bytes() for p in (source, *headers))
                         + " ".join(compiler + flags).encode()).hexdigest()
    out = BUILD_DIR / f"{name}-{key[:16]}.so"
    with _lock_for(name):
        if out.exists():
            return out, ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run(compiler + flags + ["-o", tmp, str(source)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"building {source.name} failed "
                                   f"(rc {res.returncode}):\n{res.stdout}"
                                   f"{res.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out, res.stdout + res.stderr
