"""The kernels' persistent build cache (counterpart of ``repro/runtime/compile_cache.py``).

The reference persists compiled XLA executables so that a cold process
pays a lookup instead of a recompile. The port compiles nothing at run
time but its hand-written CUDA kernels: ``nvcc`` builds each source once
into a shared library whose name carries a hash of the sources and flags
(``kernels/_cuda.py``), so this directory is the port's compile cache. A
process that finds a library there loads it; one that does not builds it
(seconds per source) and leaves it for the next.

Knobs, the reference's names:

* ``REPRO_COMPILE_CACHE_DIR`` — the cache directory (default
  ``build/kernels/`` at the repository root, listed in ``.gitignore``,
  so a fresh checkout builds every kernel from its sources);
* ``REPRO_NO_COMPILE_CACHE`` — set non-empty to opt out: libraries are
  built into a temporary directory of this process, removed at its exit,
  so nothing persists.

``cache_dir`` is where builds go now, read at every call (the reference's
returns None until the cache is enabled: the port always builds
somewhere). ``enable_persistent_cache`` is called by both launchers, as
the reference's; a caller that wants its own directory passes ``path``.
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
_enabled_dir: Path | None = None
_private_dir: Path | None = None


def _private() -> Path:
    """This process's temporary build directory, removed at exit."""
    global _private_dir
    if _private_dir is None:
        _private_dir = Path(tempfile.mkdtemp(prefix="repro-kernels-"))
        atexit.register(shutil.rmtree, _private_dir, True)
    return _private_dir


def cache_dir() -> Path:
    """Where kernel libraries and their build logs go: a per-process
    temporary directory under ``REPRO_NO_COMPILE_CACHE``, else the
    directory ``enable_persistent_cache`` was given, else
    ``REPRO_COMPILE_CACHE_DIR``, else ``build/kernels/``."""
    if os.environ.get("REPRO_NO_COMPILE_CACHE"):
        return _private()
    if _enabled_dir is not None:
        return _enabled_dir
    env = os.environ.get("REPRO_COMPILE_CACHE_DIR")
    return Path(env) if env else DEFAULT_DIR


def enable_persistent_cache(path: str | None = None) -> str | None:
    """Fix the build cache's directory for this process; returns it.

    ``path``, else ``REPRO_COMPILE_CACHE_DIR``, else ``build/kernels/``.
    Returns None when ``REPRO_NO_COMPILE_CACHE`` opts out (builds then go
    to a temporary directory). Idempotent.
    """
    global _enabled_dir
    if os.environ.get("REPRO_NO_COMPILE_CACHE"):
        return None
    env = os.environ.get("REPRO_COMPILE_CACHE_DIR")
    _enabled_dir = Path(path) if path else Path(env) if env else DEFAULT_DIR
    return str(_enabled_dir)
