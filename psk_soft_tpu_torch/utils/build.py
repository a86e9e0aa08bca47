"""Build-at-first-use for the port's native libraries.

Each library is compiled from its source in the checkout into
``build/psk_soft_tpu_torch/`` (git-ignored), under a file name keyed by a
hash of the source, the headers it includes and the compile command, so an
edited source, header or flag rebuilds and a stale library is never loaded.  The compiler writes to a
temporary name that is renamed into place, so concurrent builds (test
workers) never load a half-written file.  Builds of different libraries in
one process run in parallel (one lock per library name); a kernel
library's loader (:func:`load_once`) builds and loads it once even when
shard threads call it together.  :func:`count_launch` is the kernel
wrappers' launch count, exact under concurrent shards.
"""

from __future__ import annotations

import functools
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
_count_lock = threading.Lock()


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


def load_once(loader):
    """Run a library loader once and keep what it returns: threads that
    reach it together wait for the one build and load (a failed one is
    tried again on the next call)."""
    lock = threading.Lock()
    loaded: list = []

    @functools.wraps(loader)
    def load():
        with lock:
            if not loaded:
                loaded.append(loader())
            return loaded[0]

    return load


def count_launch(wrapper, modes=()) -> None:
    """Add one to ``wrapper.launches`` and to ``wrapper.mode_launches[m]``
    for each m of ``modes``, under one lock, so launches from concurrent
    shard threads each count exactly once."""
    with _count_lock:
        wrapper.launches += 1
        for mode in modes:
            wrapper.mode_launches[mode] += 1
