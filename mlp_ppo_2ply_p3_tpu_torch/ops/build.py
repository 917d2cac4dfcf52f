"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, and loaded with ``ctypes``.
Outputs go to ``mlp_ppo_2ply_p3_tpu_torch/build/`` (git-ignored), named
by a hash of the source, the headers it includes (``#include "x.cuh"``,
followed recursively) and the flags, so an edited kernel or header is
rebuilt.  Nothing is
built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register / shared-memory report) per source
build_logs: dict[str, str] = {}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def source_files(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every header it includes with quotes,
    recursively, each once, in the order first met."""
    files, todo = [], [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0).resolve()
        if path in files:
            continue
        files.append(path)
        todo += [path.parent / inc.decode()
                 for inc in _INCLUDE.findall(path.read_bytes())]
    return files


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def sources() -> tuple[str, ...]:
    """The names of every ``csrc/<name>.cu``."""
    return tuple(sorted(p.stem for p in CSRC_DIR.glob("*.cu")))


def build_all(names=None) -> dict[str, Path]:
    """Compile each ``csrc/<name>.cu`` (by default every source) unless
    its library is already built: one nvcc process per source, all
    started together.  Returns the library paths by name."""
    names = sources() if names is None else tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            running[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True), tmp, out)
        for name, (proc, tmp, out) in running.items():
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name}.cu (rc {proc.returncode}):\n"
                    f"{stdout}\n{stderr}"
                )
            build_logs[name] = stdout + stderr
            os.replace(tmp, out)
    finally:
        for proc, _, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {name: library_path(name) for name in names}


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    return build_all((name,))[name]


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib


def load_all() -> dict[str, ctypes.CDLL]:
    """Build every missing library at once (``build_all``), then load
    every source's."""
    names = sources()
    with _lock:
        build_all(n for n in names if n not in _loaded)
    return {name: load(name) for name in names}
