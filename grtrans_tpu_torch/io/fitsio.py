"""Minimal FITS writer and reader in numpy (no astropy).

The port's own copy of grtrans_tpu/io/fitsio.py, byte for byte the same
output.  Layout of the reference's cfitsio output (camera.f90:219-305): the
primary HDU holds the pixel coordinates ab, followed by one IMAGE
extension per camera whose header carries the run parameters as
keywords (reference README:190-208).  Data are BITPIX -32.
"""

import numpy as np

BLOCK = 2880


def _card(key, value, comment=""):
    if isinstance(value, bool):
        v = "T" if value else "F"
        s = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        s = f"{key:<8}= {value:>20d}"
    elif isinstance(value, float):
        s = f"{key:<8}= {value:>20.13E}"
    else:
        s = f"{key:<8}= '{value:<8}'"
    if comment:
        s += f" / {comment}"
    return s[:80].ljust(80)


def _header(cards):
    h = "".join(cards) + "END".ljust(80)
    pad = (-len(h)) % BLOCK
    return (h + " " * pad).encode("ascii")


def _img_hdu(data, extra_cards=(), primary=False):
    data = np.asarray(data, ">f4")
    cards = []
    if primary:
        cards.append(_card("SIMPLE", True))
    else:
        cards.append(_card("XTENSION", "IMAGE"))
    cards.append(_card("BITPIX", -32))
    cards.append(_card("NAXIS", data.ndim))
    for i, n in enumerate(data.shape[::-1]):
        cards.append(_card(f"NAXIS{i+1}", int(n)))
    if not primary:
        cards.append(_card("PCOUNT", 0))
        cards.append(_card("GCOUNT", 1))
    cards.extend(extra_cards)
    raw = data.tobytes()
    pad = (-len(raw)) % BLOCK
    return _header(cards) + raw + b"\x00" * pad


def _fits_key(name, used):
    """Map a parameter name to a unique 8-char FITS keyword."""
    k = "".join(c for c in name.upper() if c.isalnum() or c in "-_")[:8]
    base, n = k, 1
    while k in used:
        n += 1
        k = f"{base[:8 - len(str(n))]}{n}"
    used.add(k)
    return k


def write_fits(path, ab, ivals_list, key_dicts):
    """ab (npix,2) in the primary HDU; each camera an image extension.

    key_dicts entries are either float lists (written as KEYnn, the
    minimal reference-binary-style key vector) or dicts of named run
    parameters (full provenance, parity with camera.f90:219-305 which
    persists every input as a keyword)."""
    with open(path, "wb") as f:
        f.write(_img_hdu(np.asarray(ab).T.ravel(), primary=True))
        for iv, keys in zip(ivals_list, key_dicts):
            if isinstance(keys, dict):
                used = set()
                cards = []
                nkey = 0
                # numeric per-camera keys first as KEYnn for readers of
                # the minimal layout
                for name in ("freq", "mu0cam", "mdotcam", "tcam"):
                    if name in keys:
                        nkey += 1
                        used.add(f"KEY{nkey}")
                        cards.append(_card(f"KEY{nkey}",
                                           float(keys[name])))
                for name, v in keys.items():
                    if isinstance(v, (bool, np.bool_)):
                        v = bool(v)
                    elif isinstance(v, (int, np.integer)):
                        v = int(v)
                    elif isinstance(v, (float, np.floating)):
                        v = float(v)
                    else:
                        v = str(v)
                    cards.append(_card(_fits_key(name, used), v))
            else:
                cards = [_card(f"KEY{i+1}", float(v))
                         for i, v in enumerate(keys)]
            f.write(_img_hdu(np.asarray(iv).T.ravel(), extra_cards=cards))


def read_fits(path, with_headers=False):
    """Read back (ab, [ivals_flat], [keys]) from our writer's layout;
    with_headers=True appends the per-extension raw card dicts."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    hdus = []
    while off < len(data):
        # parse header
        cards = {}
        hlen = 0
        end = False
        while not end:
            block = data[off + hlen: off + hlen + BLOCK].decode("ascii",
                                                                "replace")
            for i in range(0, BLOCK, 80):
                card = block[i:i + 80]
                key = card[:8].strip()
                if key == "END":
                    end = True
                    break
                if "=" in card:
                    val = card[10:].split("/")[0].strip()
                    cards[key] = val
            hlen += BLOCK
        off += hlen
        naxis = int(cards.get("NAXIS", "0"))
        shape = [int(cards[f"NAXIS{i+1}"]) for i in range(naxis)][::-1]
        n = int(np.prod(shape)) if shape else 0
        arr = np.frombuffer(data, ">f4", n, off).reshape(shape)
        off += n * 4
        off += (-n * 4) % BLOCK
        hdus.append((cards, arr))
    ab_flat = hdus[0][1]
    npix = ab_flat.size // 2
    ab = ab_flat.reshape(2, npix).T
    cams = []
    keys = []
    headers = []
    for cards, arr in hdus[1:]:
        cams.append(arr)
        kv = [float(v) for k, v in sorted(cards.items())
              if k.startswith("KEY") and k[3:].isdigit()]
        keys.append(kv)
        headers.append(cards)
    if with_headers:
        return ab, cams, keys, headers
    return ab, cams, keys
