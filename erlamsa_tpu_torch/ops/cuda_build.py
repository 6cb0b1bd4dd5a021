"""Build the port's CUDA kernels (csrc/*.cu) for sm_90a with nvcc into
shared libraries with a plain C interface, loaded with ctypes.

A library is named by the hash of its source and of every shared header
(csrc/*.cuh), so an edit to either rebuilds it and a stale library is
never loaded. Builds land in the package's ``_build/`` directory, which
git ignores; ``build_all`` starts one nvcc per missing library at once.
Each build keeps ptxas's report (registers, spills, shared memory per
kernel) beside its library, in ``<library>.ptxas.txt``.
"""

from __future__ import annotations

import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")


def toolkit(tool: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump)."""
    found = shutil.which(tool)
    if found:
        return found
    cand = os.path.join("/usr/local/cuda/bin", tool)
    if os.path.exists(cand):
        return cand
    raise RuntimeError(f"{tool} not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


def library_path(name: str) -> str:
    """Where the library of csrc/<name>.cu lives, keyed by content."""
    h = hashlib.sha256()
    for path in [os.path.join(CSRC, name + ".cu")] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def build_all(names) -> dict[str, str]:
    """Build every missing library of ``names`` concurrently; returns
    {name: library path}. Raises with nvcc's errors if one fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    jobs = []
    for name, so in paths.items():
        if os.path.exists(so):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [toolkit(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler",
               "-fPIC",
               "-I", CSRC, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((name, so, tmp, proc))
    errors = []
    for name, so, tmp, proc in jobs:
        _out, err = proc.communicate()
        if proc.returncode == 0:
            with open(so + ".ptxas.txt", "w") as f:
                f.write(err)
            os.replace(tmp, so)
        else:
            os.unlink(tmp)
            errors.append(f"{name}: nvcc failed:\n{err[-4000:]}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def ptxas_report(name: str) -> list[tuple[str, str]]:
    """(entry, "N registers, S B spill stores, M B smem") for each kernel
    of csrc/<name>.cu, from the report its build kept."""
    with open(library_path(name) + ".ptxas.txt") as f:
        text = f.read()
    rows, entry, spill = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line and entry:
            spill = line.strip()
        elif "Used" in line and "registers" in line and entry:
            rows.append((entry, line.split(":", 1)[1].strip() + "; " + spill))
            entry = None
    return rows


def build(name: str) -> str:
    """Build csrc/<name>.cu if needed and return its library's path."""
    return build_all([name])[name]
