"""Build the CUDA sources in ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, which ``ctypes`` loads.  The
library goes into ``_build/`` beside the package (listed in
``.gitignore``) under a name that carries a hash of the sources, so an
edited source builds anew and a stale library is never loaded.  An
analysis tool may build an edited copy of a source from its own
directory (``csrc_dir``, ``build_dir``).  The
library is written to a temporary name and renamed into place, so
processes that build at the same time never load a partial file.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Build:
    """One compiled library: its path, nvcc's seconds and ptxas report."""

    name: str
    path: Path
    seconds: float
    log: str

    def ptxas_summary(self) -> list:
        """Per-kernel ``(registers, spill stores, spill loads)`` lines."""
        out = []
        for m in re.finditer(
                r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, "
                r"(\d+) bytes spill stores, (\d+) bytes spill loads\n"
                r"ptxas info\s*: Used (\d+) registers", self.log):
            out.append(f"{m.group(1)}: {m.group(5)} registers, "
                       f"{m.group(3)} B spill stores, "
                       f"{m.group(4)} B spill loads")
        return out


#: loaded libraries by path
_LIBS: Dict[Path, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else the CUDA toolkit's default."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: building the CUDA kernels needs the CUDA toolkit "
        "(nvcc on PATH or in /usr/local/cuda/bin)")


def _source_hash(name: str, csrc_dir: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(csrc_dir.glob("*.cuh")) + [csrc_dir / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _target(name: str, csrc_dir: Path, build_dir: Path) -> Path:
    return build_dir / f"lib{name}-{_source_hash(name, csrc_dir)}.so"


def build(names: Optional[Iterable[str]] = None, csrc_dir: Path = CSRC_DIR,
          build_dir: Path = BUILD_DIR) -> Dict[str, Build]:
    """Compile ``<csrc_dir>/<name>.cu`` into ``build_dir`` for every name
    (default: every ``.cu``), all nvcc processes started together.
    Raises on a failed build."""
    csrc_dir, build_dir = Path(csrc_dir), Path(build_dir)
    if names is None:
        names = sorted(p.stem for p in csrc_dir.glob("*.cu"))
    build_dir.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    jobs = {}
    builds = {}
    t0 = time.perf_counter()
    for name in names:
        target = _target(name, csrc_dir, build_dir)
        fd, tmp = tempfile.mkstemp(dir=build_dir, suffix=".so.tmp")
        os.close(fd)
        cmd = [compiler, *NVCC_FLAGS, "-o", tmp, str(csrc_dir / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, target)
    for name, (proc, tmp, target) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {csrc_dir / name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, target)
        builds[name] = Build(name, target, time.perf_counter() - t0, log)
    return builds


def load(name: str, csrc_dir: Path = CSRC_DIR,
         build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """The loaded library of ``<csrc_dir>/<name>.cu``, built first into
    ``build_dir`` if needed."""
    csrc_dir, build_dir = Path(csrc_dir), Path(build_dir)
    key = csrc_dir / name
    lib = _LIBS.get(key)
    if lib is None:
        target = _target(name, csrc_dir, build_dir)
        if not target.exists():
            build([name], csrc_dir, build_dir)
        lib = ctypes.CDLL(str(target))
        _LIBS[key] = lib
    return lib
