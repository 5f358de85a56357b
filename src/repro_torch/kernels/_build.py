"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``<kernel>/csrc/<kernel>.cu`` exposes a plain C interface, so ``nvcc``
compiles it without PyTorch's headers in seconds.  Libraries go to
``build/torch_kernels/`` at the repository root (ignored by git), named by
a hash of every file in the source's ``csrc/`` directory (the ``.cu`` and
any header it includes) and the flags, so an edited source or header
rebuilds and an unchanged one is reused.  ``build`` starts one ``nvcc``
per missing source, all at once.  ``launch`` calls a C entry on a
device's current stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
#: kernel name -> CUDA source
SOURCES = {
    "kth_free": _HERE / "kth_free" / "csrc" / "kth_free.cu",
    "ep": _HERE / "ep" / "csrc" / "ep.cu",
    "is_hist": _HERE / "is_hist" / "csrc" / "is_hist.cu",
    "stencil7": _HERE / "stencil3d" / "csrc" / "stencil7.cu",
    "flash_attention": _HERE / "flash_attention" / "csrc" / "flash_attention.cu",
    "ssd_scan": _HERE / "ssd_scan" / "csrc" / "ssd_scan.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = _HERE.parents[2] / "build" / "torch_kernels"

_loaded: dict[str, ctypes.CDLL] = {}
_raw_stream = None


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME
    (default ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's compiler")
    return str(path)


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library is built: named by a hash of every
    file of its ``csrc/`` directory, names and contents, and the flags."""
    h = hashlib.sha256()
    for path in sorted(p for p in SOURCES[name].parent.iterdir()
                       if p.is_file()):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile every named kernel whose library is missing, one ``nvcc``
    each, all started together.  Returns ``{name: {"seconds", "log"}}`` for
    the kernels it compiled (``log`` is nvcc's ``-Xptxas -v`` report)."""
    names = tuple(SOURCES) if names is None else tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def function(name: str, symbol: str, argtypes):
    """The C entry ``symbol`` of kernel ``name``'s library, with its
    argument types declared (pointers and the stream as ``c_void_p``:
    undeclared, ctypes would pass them as 32-bit ints) and an ``int``
    (CUDA error code) result."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def launch(device: int, call) -> int:
    """``call(stream)`` with the raw current stream of CUDA device
    ``device`` (an index), entering that device only when it is not the
    current one.  ``call`` passes the stream to a C entry, which launches
    on it; returns what ``call`` returns, the entry's CUDA error code.
    Every kernel wrapper of the port launches through here."""
    global _raw_stream
    if _raw_stream is None:
        _raw_stream = torch._C._cuda_getCurrentRawStream
    if device == torch.cuda.current_device():
        return call(_raw_stream(device))
    with torch.cuda.device(device):
        return call(_raw_stream(device))
