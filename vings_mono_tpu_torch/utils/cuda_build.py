"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Each source compiles with nvcc for sm_90a into its own shared library with
a plain C interface, loaded with ctypes. Libraries go to
`build/torch_kernels/` at the repository root, named by a hash of the
sources, flags and macro definitions, so an edited source rebuilds and an
unchanged one loads at once. Nothing is compiled at import time. `defines`
("NAME=VALUE" strings) builds a source with macros set, into a library of
its own.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def sources():
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name, defines=()):
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join([*NVCC_FLAGS, *defines]).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None, defines=()):
    """Compile every named source (default: all) whose library is missing,
    one nvcc process per source, all started together. Returns
    {name: (library path, seconds, ptxas report)}; raises on a failed
    build."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo, done = {}, {}
    for name in names:
        lib = library_path(name, defines)
        if lib.is_file():
            done[name] = (lib, 0.0, "")
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
               str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        todo[name] = (proc, tmp, lib, time.perf_counter())
    errors = []
    for name, (proc, tmp, lib, t0) in todo.items():
        out, err = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n"
                          f"{out}{err}")
            continue
        os.replace(tmp, lib)
        done[name] = (lib, secs, err)
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


@functools.lru_cache(maxsize=None)
def load(name, defines=()):
    """ctypes handle of csrc/<name>.cu's library, built on first use."""
    lib, _, _ = build([name], defines)[name]
    return ctypes.CDLL(str(lib))
