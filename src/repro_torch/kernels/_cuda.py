"""Build and bind the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each kernel is one ``.cu`` file with a plain C interface, compiled for
``sm_90a`` at first use into the build cache (``runtime/compile_cache``:
``build/kernels/`` at the repository root by default, listed in
``.gitignore``). The library name carries a hash of the
sources and flags, so an edited source is rebuilt and a stale library is
never loaded. No ``nvcc`` runs when a module is imported: a CPU-only
process never builds anything.

``CudaKernel.launch`` calls one exported function (pointers as
``c_void_p``, then the tensors' device ordinal and PyTorch's current
stream on it), raises if it returns a CUDA error, and counts the launch.
Several kernels of one source (a forward and its backward) share one
library (``library_name``) and keep a launch count each.

Cost tallies: while one is active (``TALLIES`` is not empty), every
wrapper reports its kernel's work (FLOPs and bytes from the shapes, by
the kernel's own cost function) through ``record_cost`` once per call,
on every device; with none active it reckons no cost. A plain CPU
version runs under ``uncounted``. A tally (``launch/dryrun.Counter``)
so reads each kernel's work from its cost function, never from the
operations that implement it: a count is the same on ``meta``, on the
CPU and on the card.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent
INCLUDE_DIR = PKG_DIR / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def build_dir() -> Path:
    """The build cache's directory (``runtime/compile_cache.cache_dir``;
    imported here, not at the top: ``repro_torch.runtime`` imports the
    models, which import the kernels)."""
    from repro_torch.runtime import compile_cache

    return compile_cache.cache_dir()


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); cannot build kernels")


#: the active cost tallies, innermost last (``launch/dryrun.Counter``)
TALLIES: list = []


def record_cost(name: str, flops: float, nbytes: float, inputs=(), outputs=()) -> None:
    """Report one call of kernel ``name`` to every active tally: its work
    (``flops``, ``nbytes``, from the kernel's cost function), the tensors
    it reads and the ones it writes."""
    for tally in TALLIES:
        tally.kernel(name, flops, nbytes, inputs, outputs)


@contextlib.contextmanager
def uncounted():
    """Hide the operations of a plain version from every active tally (its
    kernel's work is reported by ``record_cost``)."""
    for tally in TALLIES:
        tally.paused += 1
    try:
        yield
    finally:
        for tally in TALLIES:
            tally.paused -= 1


class CudaKernel:
    """One hand-written CUDA kernel: its source, exported functions, launches."""

    def __init__(self, name: str, source: Path, functions: dict[str, list],
                 library_name: str | None = None):
        self.name = name
        self.library_name = library_name or name
        self.source = Path(source)
        self.functions = functions  # exported symbol -> ctypes argtypes
        self.launches = 0
        self._lib: ctypes.CDLL | None = None

    def _digest(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in [self.source, *sorted(INCLUDE_DIR.glob("*.cuh"))]:
            h.update(path.read_bytes())
        return h.hexdigest()[:16]

    @property
    def library(self) -> Path:
        return build_dir() / f"lib{self.library_name}-{self._digest()}.so"

    @property
    def log(self) -> Path:
        return build_dir() / f"{self.library_name}.log"

    def build_command(self, out: Path) -> list[str]:
        return [nvcc(), *NVCC_FLAGS, f"-I{INCLUDE_DIR}", "-o", str(out),
                str(self.source)]

    def load(self) -> ctypes.CDLL:
        """The bound library, built first if this source was never built."""
        if self._lib is None:
            if not self.library.exists():
                build_all([self])
            lib = ctypes.CDLL(str(self.library))
            for fn, argtypes in self.functions.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, fn: str, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; raise on any CUDA error."""
        lib = self.load()
        index = device.index if device.index is not None else torch.cuda.current_device()
        stream = torch.cuda.current_stream(index).cuda_stream
        rc = getattr(lib, fn)(*args, index, stream)
        if rc != 0:
            msg = lib.repro_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: {fn} failed: CUDA error {rc} ({msg})")
        self.launches += 1


def build_all(kernels) -> None:
    """Compile every kernel whose library is missing, all nvcc's at once.

    Output goes to a temporary name and is renamed into place, so a
    concurrent reader never loads a half-written library. The compiler's
    output (``-Xptxas -v``: registers, shared memory, spills) is kept in
    ``<cache dir>/<library_name>.log`` (``compile_cache.cache_dir``,
    ``build/kernels/`` by default). Kernels that share a library build it
    once.
    """
    build_dir().mkdir(parents=True, exist_ok=True)
    jobs, seen = [], set()
    for k in kernels:
        out = k.library
        if out.exists() or out in seen:
            continue
        seen.add(out)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        with open(k.log, "w") as log:
            proc = subprocess.Popen(k.build_command(tmp), stdout=log,
                                    stderr=subprocess.STDOUT)
        jobs.append((k, proc, tmp, out))
    failed = []
    for k, proc, tmp, out in jobs:
        if proc.wait() != 0:
            failed.append(f"{k.library_name}:\n{k.log.read_text()}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
