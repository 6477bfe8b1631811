"""Geodesic bundles saved to and restored from disk (the reference's
precomputed-geodesic file, geodesics.f90:155-187 load_geodesic).

The port's own copy of grtrans_tpu/geodesics/cache.py: the same .npz
layout (one array a GeodesicBundle field, plus the content key as 8
bytes under `_key`) and the same key, so a bundle written by either
package loads in the other.  A hit skips the trace; a bundle written for
other camera or trace parameters, or a file that is absent or cannot be
read, is a miss.
"""

import hashlib
import json
import os
import zipfile

import numpy as np
import torch

from grtrans_tpu_torch.geodesics.geokerr import GeodesicBundle


def bundle_key(a, mu0, npts, uout, phi0, standard, gridvals, nro, nphi,
               nrotype=0, rcut=1.0, i1=0, i2=0):
    """Deterministic content key of a traced camera.  i1/i2 is the pixel
    subrange (read_inputs.f90:22-23): two equal-length but different
    subranges must not match each other."""
    blob = json.dumps([float(a), float(mu0), int(npts),
                       None if uout is None else float(uout), float(phi0),
                       int(standard), [float(g) for g in gridvals],
                       int(nro), int(nphi), int(nrotype), float(rcut),
                       int(i1), int(i2)])
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def save_bundle(path, geo: GeodesicBundle, key=None):
    """Write `geo` (tensors on any device) and its content key to `path`
    (.npz).  The file appears whole or not at all: it is written to a
    temporary name in the same directory and renamed into place."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arrays = {f: getattr(geo, f).cpu().numpy() for f in geo._fields}
    if key is not None:
        arrays["_key"] = np.frombuffer(bytes.fromhex(key), dtype=np.uint8)
    # np.savez appends .npz to a name without it: keep the suffix so the
    # temporary name is the one written
    tmp = path + f".tmp{os.getpid()}.npz"
    try:
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_bundle(path, key=None, *, device):
    """The GeodesicBundle at `path` as tensors on `device`, or None when
    the file is absent, unreadable or was written for other parameters
    (the caller then traces afresh)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            if key is not None:
                stored = z["_key"].tobytes().hex() if "_key" in z else None
                if stored != key:
                    return None
            arrays = {f: z[f] for f in GeodesicBundle._fields}
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None
    geo = {f: torch.as_tensor(v, device=device) for f, v in arrays.items()}
    geo["status"] = geo["status"].to(torch.int32)
    return GeodesicBundle(**geo)
