"""Raw binary camera output, byte-compatible with the reference's
Fortran unformatted writer and with grtrans_tpu/io/binio.py, of which this
is the port's own copy (numpy only) (camera.f90:322-341; format documented in
reference README:209-218 and parsed by grtrans_batch.py:449-476).

Per camera record group:
  rec1: int32 nx, ny, nvals
  rec2: int32 nkey
  rec3: float32 keyvals(nkey)
  rec4: float32 ab(2, nx*ny)   (pixel coordinates)
  rec5: float32 ivals(nvals, nx*ny)
Each Fortran record is wrapped in 4-byte length markers.
"""

import numpy as np


def _rec(payload: bytes) -> bytes:
    n = np.int32(len(payload)).tobytes()
    return n + payload + n


def write_camera_bin(path, ab, ivals_list, keyvals_list, nx, ny, append=False):
    """Write cameras to the reference raw binary layout.

    ab: (npix, 2); ivals_list: list of (npix, nvals) per camera;
    keyvals_list: list of key-value float arrays (first entry = frequency).
    """
    mode = "ab" if append else "wb"
    with open(path, mode) as f:
        for ivals, keys in zip(ivals_list, keyvals_list):
            nvals = ivals.shape[1]
            f.write(_rec(np.asarray([nx, ny, nvals], np.int32).tobytes()))
            keys = np.asarray(keys, np.float32)
            f.write(_rec(np.asarray([len(keys)], np.int32).tobytes()))
            f.write(_rec(keys.tobytes()))
            f.write(_rec(np.asarray(ab, np.float32).T.ravel().tobytes()))
            f.write(_rec(np.asarray(ivals, np.float32).T.ravel()
                         .tobytes()))


def read_camera_bin(path):
    """Read all cameras; returns (ab (npix,2), [ivals (npix,nvals)], [keys])."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0

    def rec():
        nonlocal off
        n = int(np.frombuffer(data, np.int32, 1, off)[0])
        payload = data[off + 4: off + 4 + n]
        off += 8 + n
        return payload

    cams = []
    keys_all = []
    ab = None
    while off < len(data):
        nx, ny, nvals = np.frombuffer(rec(), np.int32)
        nkey = int(np.frombuffer(rec(), np.int32)[0])
        keys = np.frombuffer(rec(), np.float32, nkey)
        abf = np.frombuffer(rec(), np.float32).reshape(2, nx * ny).T
        iv = np.frombuffer(rec(), np.float32).reshape(nvals, nx * ny).T
        ab = abf
        cams.append(iv)
        keys_all.append(keys)
    return ab, cams, keys_all
