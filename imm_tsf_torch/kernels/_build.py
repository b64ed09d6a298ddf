"""Build the CUDA kernels under `csrc/`, and the host libraries in
`HOST_SOURCES`, at first use and load them.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
into its own shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -o lib<name>.so <name>.cu

A host library (C++ for the CPU, such as the native chunker
`native/chunker.cpp`) takes the host compiler instead:

    g++ -O3 -shared -fPIC -o lib<name>.so <name>.cpp

The library lands in `imm_tsf_torch/_build/<hash>/`, keyed by a hash of
the sources, headers and flags, so an edited source is rebuilt and an
unchanged one is reused. It is loaded with `ctypes`. Only the repo's own
sources are built; a failed build raises and nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
HOST_FLAGS = ("-O3", "-shared", "-fPIC")
HOST_SOURCES = {"chunker": _PKG / "native" / "chunker.cpp"}  # name -> its C++ source

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
            "CUDA kernels are built from csrc/ at first use")
    return found


def _gxx() -> str:
    found = shutil.which(os.environ.get("CXX") or "g++")
    if found is None:
        raise RuntimeError("g++ not found (set CXX or put g++ on PATH): the port's host "
                           "libraries are built from their C++ sources at first use")
    return found


def _command(name: str, out: Path) -> list[str]:
    """The compiler command that builds `name` into `out`."""
    if name in HOST_SOURCES:
        return [_gxx(), *HOST_FLAGS, "-o", str(out), str(HOST_SOURCES[name])]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def library_path(name: str) -> Path:
    if name in HOST_SOURCES:
        flags, sources = HOST_FLAGS, [HOST_SOURCES[name]]
    else:
        flags, sources = NVCC_FLAGS, [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def build(names) -> dict[str, float]:
    """Compile every library in `names` that is not built yet, one
    compiler process per source, all started together. Returns each
    name's build seconds (0.0 when it was already built)."""
    todo, seconds = [], {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = _command(name, tmp)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        todo.append((name, out, tmp, cmd, proc, time.monotonic()))
    failures = []
    for name, out, tmp, cmd, proc, t0 in todo:
        log, _ = proc.communicate()
        seconds[name] = time.monotonic() - t0
        if proc.returncode != 0:
            failures.append(f"{os.path.basename(cmd[0])} failed for {cmd[-1]}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library `name` (`csrc/<name>.cu` or a host library),
    built first if needed.

    signatures: {function: (argtypes, restype)} declared before the
    library is handed out (pointers and the stream as c_void_p, so ctypes
    never cuts them to 32 bits)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _loaded[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry returned a nonzero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError_t {rc})")
