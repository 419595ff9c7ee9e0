"""Build the port's CUDA kernels from the sources in ``kernels/csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, ``build/lib<name>-<hash>.so`` at the root of the
checkout, and is loaded with ``ctypes``.  The hash covers the source,
the headers of ``csrc/`` and the flags, so an edited source or header
rebuilds on its next use and an unchanged one is reused.
``build(names)`` starts one ``nvcc`` per missing library, all at once,
and waits for them all.

Nothing here runs at import: the kernels build on first use, on a machine
with the CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}     # one load per library per process


def toolkit_binary(name: str) -> str:
    """A CUDA toolkit program (``nvcc``, ``cuobjdump``) on PATH or under
    /usr/local/cuda/bin."""
    path = shutil.which(name)
    if path is None and os.path.exists(f"/usr/local/cuda/bin/{name}"):
        path = f"/usr/local/cuda/bin/{name}"
    if path is None:
        raise RuntimeError(f"{name} not found: building the CUDA kernels "
                           "needs the CUDA toolkit (on PATH or "
                           "/usr/local/cuda)")
    return path


def nvcc() -> str:
    return toolkit_binary("nvcc")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to under the current flags.  The
    hash covers the source, every header of ``csrc/`` (so a changed
    header rebuilds the sources that include it) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) for the
    library as last built, or "" if it was not built in this checkout."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def sass(name: str) -> str:
    """The SASS of the built library for ``csrc/<name>.cu``, as
    ``cuobjdump -sass`` prints it (building the library if needed)."""
    so = build([name])[name]
    return subprocess.run([toolkit_binary("cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def build(names) -> dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source started together; raise with the compiler's output if any
    fails.  Returns name → library path."""
    targets = {name: library_path(name) for name in names}
    jobs = []
    for name, so in targets.items():
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        log = so.with_suffix(".log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=fh, stderr=subprocess.STDOUT)
        jobs.append((name, proc, tmp, so, log))
    failed = []
    for name, proc, tmp, so, log in jobs:
        if proc.wait() == 0:
            os.replace(tmp, so)          # atomic: readers never see half
        else:
            failed.append(f"{name}:\n{log.read_text()}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LOADED[name] = lib
    return lib
