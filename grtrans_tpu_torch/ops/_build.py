"""The nvcc build of the port's hand-written CUDA sources (csrc/*.cu).

    so = build(source, flags)      # compile unless built; the library path

Each source is compiled for sm_90a with NVCC_FLAGS and its own `flags`
into grtrans_tpu_torch/_build/, one shared library a source and flag set:
the name carries a hash of the source's bytes and of every flag, so that
neither a changed source nor a changed flag loads a library built before
it.  ptxas's register and spill report is kept beside the library as a
.log; each nvcc run counts "kernel_builds".
"""

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from grtrans_tpu_torch import obs

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v")


def nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is not None:
        path = Path(CUDA_HOME) / "bin" / "nvcc"
        if path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(source, flags=()):
    """Path of the library built from `source` with `flags`, named after
    the source and a hash of its bytes and of the whole flag list."""
    h = hashlib.sha256(Path(source).read_bytes())
    h.update("\0".join((*NVCC_FLAGS, *flags)).encode())
    return BUILD_DIR / f"lib{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build(source, flags=()):
    """Compile `source` with NVCC_FLAGS and `flags` unless that library
    exists; returns its path."""
    so = library_path(source, flags)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(source)]
    obs.count("kernel_builds")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, so)
    return so
