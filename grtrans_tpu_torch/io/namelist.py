"""Fortran-namelist input files of the reference, read and written.

The port's own copy of grtrans_tpu/io/namelist.py (numpy only).  The
reference is driven by `files.in` (&files ifile, ofile;
grtrans_program.f90:4-11) pointing at an inputs file of six namelists
(&geodata &fluiddata &emisdata &general and a model-parameter group such
as &harm or &analytic; read_inputs.f90:8-20, template inputs.in.dist).
This module reads and writes that format and maps it onto GrtransConfig,
so the reference's input files drive the port unchanged.
"""

import inspect
import re

from grtrans_tpu_torch.config import GrtransConfig


def _parse_value(tok):
    tok = tok.strip()
    if not tok:
        return None
    if tok[0] in "'\"":
        return tok.strip("'\"")
    low = tok.lower().rstrip(".")
    if low in (".true.", "t", "true"):
        return True
    if low in (".false.", "f", "false"):
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return tok


def parse_namelists(text):
    """Parse namelist text -> {group: {key: value-or-tuple}}."""
    groups = {}
    current = None
    for raw in text.splitlines():
        line = raw.split("!")[0].strip()
        if not line:
            continue
        if line.startswith("&"):
            current = line[1:].strip().lower()
            groups[current] = {}
            continue
        if line.startswith("/"):
            current = None
            continue
        if current is None or "=" not in line:
            continue
        key, _, val = line.partition("=")
        vals = [v for v in re.split(r",(?=(?:[^']*'[^']*')*[^']*$)",
                                    val.strip().rstrip(","))
                if v.strip() != ""]
        parsed = [_parse_value(v) for v in vals]
        groups[current][key.strip().lower()] = (
            parsed[0] if len(parsed) == 1 else tuple(parsed))
    return groups


def read_files_in(path="files.in"):
    """&files ifile, ofile (grtrans_program.f90:4-11)."""
    with open(path) as f:
        files = parse_namelists(f.read()).get("files", {})
    return files.get("ifile"), files.get("ofile")


# GrtransConfig fields fed directly from the four core namelists
_CORE_KEYS = {
    "standard", "mumin", "mumax", "nmu", "phi0", "spin", "uout", "uin",
    "rcut", "nrotype", "gridvals", "nn", "i1", "i2", "extra", "debug",
    "fname", "dt", "nt", "nload", "nmdot", "mdotmin", "mdotmax",
    "sigcut", "ename", "mbh", "nfreq", "fmin", "fmax", "muval", "gmin",
    "gmax", "p1", "p2", "jetalpha", "stype", "use_geokerr", "nvals",
    "iname", "cflag",
}

# harm/analytic-group names (f-prefix stripped) -> the models' keywords
_FARG_RENAMES = {
    "nscl": "n0", "tscl": "t0", "nnthscl": "nnth0", "nnthp": "pnth",
    "np": "pn", "tp": "pt",
}


def config_from_groups(groups):
    """Six reference namelists -> GrtransConfig (+ fargs)."""
    kw = {}
    fargs = {}
    for gname, vals in groups.items():
        for key, v in vals.items():
            if gname in ("geodata", "fluiddata", "emisdata", "general"):
                if key in _CORE_KEYS:
                    kw[key] = v
                elif key == "delta":
                    kw.setdefault("epotherargs", (v,))
                elif key == "coefindx":
                    kw["epcoefindx"] = v if isinstance(v, tuple) else (v,)
            else:
                # model-parameter groups: strip the reference's 'f'
                # prefix (fdfile -> dfile, fnscl -> nscl -> n0, ...)
                k = key[1:] if key.startswith("f") and len(key) > 1 \
                    else key
                fargs[_FARG_RENAMES.get(k, k)] = v
    if "stype" in kw and isinstance(kw["stype"], str):
        kw["stype"] = kw["stype"].lower()
    cfg = GrtransConfig(**kw)
    cfg.fargs = _filter_fargs(cfg.fname, fargs)
    return cfg


def _filter_fargs(fname, fargs):
    """Keep only the parameters the fluid model `fname` takes: the
    reference passes a flat 40+ member fluid_args bag (fluid.f90:59-66),
    the port's factories take keywords, named by inspect.signature (which
    follows a factory's __wrapped__ to the callable its **fargs feed)."""
    from grtrans_tpu_torch.fluid import base
    base.import_all_models()
    factory = base._REGISTRY.get(fname.upper())
    if factory is None:
        return fargs
    params = inspect.signature(factory).parameters.values()
    names = {p.name for p in params
             if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}
    names.discard("device")
    return {k: v for k, v in fargs.items() if k in names}


def read_inputs(path):
    """inputs.in -> GrtransConfig."""
    with open(path) as f:
        return config_from_groups(parse_namelists(f.read()))


def _fmt(v):
    if isinstance(v, bool):
        return "T" if v else "F"
    if isinstance(v, str):
        return f"'{v}'"
    if isinstance(v, (tuple, list)):
        return ",".join(_fmt(x) for x in v)
    return str(v)


def write_inputs(cfg: GrtransConfig, path, fargs_group="analytic"):
    """GrtransConfig -> reference-format namelist file (the layout of
    grtrans_batch.grtrans_inputs.write / inputs.in.dist)."""
    geod = ["standard", "mumin", "mumax", "nmu", "phi0", "spin", "uout",
            "uin", "rcut", "nrotype", "gridvals", "nn", "i1", "i2",
            "extra", "debug"]
    flud = ["fname", "dt", "nt", "nload", "nmdot", "mdotmin", "mdotmax",
            "sigcut"]
    emis = ["ename", "mbh", "nfreq", "fmin", "fmax", "muval", "gmin",
            "gmax", "p1", "p2", "jetalpha", "stype"]
    genl = ["use_geokerr", "nvals", "iname", "cflag"]
    with open(path, "w") as f:
        for group, keys in (("geodata", geod), ("fluiddata", flud),
                            ("emisdata", emis), ("general", genl)):
            f.write(f"&{group}\n")
            for k in keys:
                f.write(f" {k}={_fmt(getattr(cfg, k))},\n")
            if group == "emisdata" and cfg.epcoefindx is not None:
                f.write(f" coefindx={_fmt(cfg.epcoefindx)},\n")
            f.write("/\n")
        f.write(f"&{fargs_group}\n")
        for k, v in cfg.fargs.items():
            f.write(f" f{k}={_fmt(v)},\n")
        f.write("/\n")


def write_files_in(ifile, ofile, path="files.in"):
    with open(path, "w") as f:
        f.write(f"&files\n ifile='{ifile}',\n ofile='{ofile}',\n/\n")
