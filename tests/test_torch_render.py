"""The port's main path end to end: the FFJET flagship configuration
(POLSYNCHPL, spin 0.998, mu0 0.906, uout 0.01, formal integrator) on the
synthetic dump at 16x16 pixels x 64 points, float64, against
grtrans_tpu's grtrans_run.  Bar: whole-image relative L1 <= 1e-8 over
IQUV (measured 1.4e-10)."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from grtrans_tpu.config import GrtransConfig as JConfig
from grtrans_tpu.fluid.ffjet import FFJet as JFFJet
from grtrans_tpu.fluid.ffjet import load_ffjet_file
from grtrans_tpu.orchestrator import grtrans_run as jrun
from grtrans_tpu_torch import convert
from grtrans_tpu_torch.orchestrator import grtrans_run as trun
from grtrans_tpu_torch.parallel import sharding
from grtrans_tpu_torch.testing.ffjet_dump import write_ffjet_dump

torch.set_num_threads(1)   # the suite runs in parallel worker processes

REPO = Path(__file__).resolve().parents[1]


def flagship_kwargs(dfile, nn=(16, 16, 64)):
    return dict(fname="FFJET", ename="POLSYNCHPL", nvals=4, spin=0.998,
                standard=1, nn=nn, uout=0.01, mbh=3.4e9, mumin=0.906,
                mumax=0.906, nfreq=1, fmin=3.45e11, fmax=3.45e11,
                gridvals=(-40.0, 20.0, -20.0, 40.0), iname="formal",
                fargs=dict(dfile=str(dfile), ntscl=2.0, nrscl=70.0))


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    dfile = tmp_path_factory.mktemp("ffjet") / "ffjet.bin"
    write_ffjet_dump(dfile)
    cfg = JConfig(**flagship_kwargs(dfile))
    ref, ab_ref, _ = jrun(cfg, model=JFFJet(dfile=str(dfile), ntscl=2.0,
                                            nrscl=70.0))
    model = convert.ffjet_from_arrays(*load_ffjet_file(dfile), device="cpu")
    ours, ab, freqs = trun(convert.config_from_jax(cfg), model, device="cpu")
    return ref, ab_ref, ours.numpy(), ab.numpy(), freqs


def test_image_matches_jax(renders):
    ref, ab_ref, ours, ab, freqs = renders
    assert ours.shape == ref.shape == (1, 256, 4)
    np.testing.assert_array_equal(ab, ab_ref)
    np.testing.assert_array_equal(freqs, [3.45e11])
    assert np.isfinite(ours).all()
    rel_l1 = np.abs(ours - ref).sum() / np.abs(ref).sum()
    print(f"I max: port {ours[0, :, 0].max():.9e}, "
          f"grtrans_tpu {ref[0, :, 0].max():.9e}; rel L1 {rel_l1:.3e}")
    assert rel_l1 <= 1e-8


def test_image_is_a_polarized_jet(renders):
    _, _, ours, _, _ = renders
    I, Q, U = ours[0, :, 0], ours[0, :, 1], ours[0, :, 2]
    assert I.max() > 0 and (I >= 0).all()
    lp = np.sqrt(Q ** 2 + U ** 2)[I > 0] / I[I > 0]
    assert 0.0 < lp.max() <= 1.0


def test_registry_load_and_unported_options(tmp_path):
    """grtrans_run loads FFJET by name from cfg.fargs, renders
    prec="mixed" (4x4x32: a finite float64 image within 2e-3 of max|I| of
    the float64 one, tests/test_precision.py's bar; measured 2.9e-7) and
    refuses a precision it does not have, and raises ValueError for a
    fluid name neither package knows; a mesh of one process and a gdfile
    bundle render the image of a plain run."""
    dfile = tmp_path / "ffjet.bin"
    write_ffjet_dump(dfile, nx=32)
    cfg = convert.config_from_jax(JConfig(**flagship_kwargs(dfile,
                                                            (6, 6, 24))))
    by_name, _, _ = trun(cfg, device="cpu")
    model = convert.ffjet_from_arrays(*load_ffjet_file(dfile), device="cpu")
    preloaded, _, _ = trun(cfg, model, device="cpu")
    assert torch.equal(by_name, preloaded)
    small = dataclasses.replace(cfg, nn=(4, 4, 32))
    mixed, _, _ = trun(dataclasses.replace(small, prec="mixed"), model,
                       device="cpu")
    f64, _, _ = trun(small, model, device="cpu")
    assert mixed.dtype == torch.float64 and torch.isfinite(mixed).all()
    assert (mixed - f64).abs().max() <= 2e-3 * f64[..., 0].abs().max()
    with pytest.raises(ValueError, match="mixed"):
        trun(dataclasses.replace(cfg, prec="f16"), device="cpu")
    for name in ("RIAF", "HARM2D", "KORALRAD"):
        with pytest.raises(ValueError, match=f"unknown fluid model '{name}'"):
            trun(dataclasses.replace(cfg, fname=name), device="cpu")
    # a gloo world of one in this process renders the same image; the
    # group goes with the test, so no other test sees it
    assert not dist.is_initialized()
    try:
        meshed, _, _ = trun(cfg, model, device="cpu",
                            mesh=sharding.pixel_mesh(device_type="cpu"))
    finally:
        dist.destroy_process_group()
    assert torch.equal(meshed, preloaded)
    for _ in range(2):                  # traces and saves, then loads
        cached, _, _ = trun(cfg, model, device="cpu",
                            gdfile=str(tmp_path / "geo.npz"))
        assert torch.equal(cached, preloaded)
    # the diagnostic channels ride behind the same Stokes columns
    extra, _, _ = trun(dataclasses.replace(cfg, extra=1), model, device="cpu")
    assert extra.shape == (1, 36, 4 + 19)
    torch.testing.assert_close(extra[..., :4], preloaded, rtol=0.0,
                               atol=1e-12 * preloaded.abs().max().item())


def test_pixel_subrange_is_a_slice_of_the_camera(tmp_path):
    """cfg.i1/i2 (1-based, inclusive) render exactly those pixels; rays
    are independent, so they match the full camera's rows."""
    dfile = tmp_path / "ffjet.bin"
    write_ffjet_dump(dfile, nx=32)
    cfg = convert.config_from_jax(JConfig(**flagship_kwargs(dfile,
                                                            (6, 6, 24))))
    model = convert.ffjet_from_arrays(*load_ffjet_file(dfile), device="cpu")
    full, ab_full, _ = trun(cfg, model, device="cpu")
    part, ab, _ = trun(dataclasses.replace(cfg, i1=5, i2=20), model,
                       device="cpu")
    assert part.shape == (1, 16, 4)
    assert torch.equal(ab, ab_full[:, 4:20])
    torch.testing.assert_close(part, full[:, 4:20], rtol=1e-13, atol=0.0)


def test_port_imports_no_jax():
    """Every module of the port, the command line's __main__ too; importing
    them opens no process group and starts no process."""
    code = ("import importlib, pkgutil, sys, grtrans_tpu_torch as p\n"
            "names = [m.name for m in\n"
            "         pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "want = {'__main__', 'io.namelist', 'io.fitsio',\n"
            "        'geodesics.cache', 'tools.geodebug', 'tools.pgriter',\n"
            "        'ops.elliptic', 'ops.interp', 'ops.quadrature',\n"
            "        'parallel.sharding', 'parallel.dryrun',\n"
            "        'tools.invert', 'tools.emitter_observer', 'ops.scalar'}\n"
            "missing = {p.__name__ + '.' + w for w in want} - set(names)\n"
            "assert not missing, missing\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'grtrans_tpu')]\n"
            "assert not bad, bad\n"
            "import multiprocessing, torch.distributed as dist\n"
            "assert not dist.is_initialized()\n"
            "assert not multiprocessing.active_children()\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
