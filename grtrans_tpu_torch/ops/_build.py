"""The nvcc build, load and launch of the port's hand-written CUDA sources
(csrc/*.cu): the one place where a source becomes a launchable entry point.

    lib = load(source, flags, signatures)   # compiled if need be, loaded once
    launch(lib.name_f64, device, *args)     # on the device's current stream

Each source is compiled for sm_90a with NVCC_FLAGS and its own `flags`
into grtrans_tpu_torch/_build/, one shared library a source and flag set:
the name carries a hash of the source's bytes and of every flag, so that
neither a changed source nor a changed flag loads a library built before
it.  ptxas's register and spill report is kept beside the library as a
.log; each nvcc run counts "kernel_builds".

Every entry point returns a C int; one that launches returns the CUDA error
(0: launched) and takes the stream last.  `signatures` gives each entry
point's ctypes argument types, the stream's c_void_p included; load refuses
a source whose extern "C" declarations (entry_points) differ from them, as
a launch through a drifted signature would pass arguments of the wrong
width.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

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


# the C parameter types of the entry points and the ctypes type of each
C_TYPES = {"long long": ctypes.c_longlong, "int": ctypes.c_int,
           "double": ctypes.c_double, "float": ctypes.c_float}


def entry_points(source):
    """name -> the ctypes type of each parameter, of every extern "C" int
    function of `source` (a pointer, the stream among them, is c_void_p)."""
    found = {}
    for name, params in re.findall(r'extern\s+"C"\s+int\s+(\w+)\s*'
                                   r'\(([^)]*)\)', Path(source).read_text()):
        types = []
        for param in filter(None, (" ".join(p.split())
                                   for p in params.split(","))):
            if "*" in param:
                types.append(ctypes.c_void_p)
            else:
                words = param.replace("const ", "").split()
                types.append(C_TYPES[" ".join(words[:-1])])
        found[name] = types
    return found


_libs = {}


def load(source, flags, signatures):
    """The library of `source` built with `flags`, loaded once a process
    under the set-up span "setup.kernels" (`source`, `built`: whether nvcc
    ran): each entry point of `signatures` (name -> ctypes argument types)
    bound to them, returning a C int.  Raises ValueError where the
    source's entry points are not those of `signatures`."""
    key = (str(source), tuple(flags))
    lib = _libs.get(key)
    if lib is None:
        declared = entry_points(source)
        if declared != {k: list(v) for k, v in signatures.items()}:
            raise ValueError(f"{Path(source).name}: its extern \"C\" entry "
                             "points differ from the signatures given")
        with obs.setup("kernels", source=Path(source).name) as rec:
            rec.attrs["built"] = not library_path(source, flags).exists()
            lib = ctypes.CDLL(str(build(source, flags)))
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _libs[key] = lib
    return lib


def launch(fn, device, *args):
    """Call the entry point `fn` with `args` and the current stream of the
    CUDA `device` (no sync); raise on a CUDA error."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")
