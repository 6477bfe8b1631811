"""The slice as a whole: grtrans_tpu_torch.api.Grtrans against
grtrans_tpu.api.Grtrans on the analytic fluids with thermal and hybrid
synchrotron and the formal, lsoda and delo integrators, at 8x8 pixels x 32
points and two frequencies, on the CPU.

Bars.  Whole-image relative L1 over all Stokes components and cameras
<= 1e-8, the bar of the FFJET render.  1e-10 does not hold: at 1e11 Hz
these rays are Faraday-thick, so roundoff in the geodesics and the
coefficients turns into polarization angle; jitted grtrans_tpu against
grtrans_tpu run eagerly (jax.disable_jit) differs by 4.1e-9 on the hybrid /
lsoda configuration, the port from the jitted run by 4.4e-9 (thermal /
formal 1.9e-10, power law / delo 1.7e-7 before its temperature was raised
into the emitting range).  Stokes I alone agrees to 6e-10.  Spectra of I to
1e-9 relative, of Q, U, V to 1e-7 of I, centroids and sizes to 1e-7,
polarization fractions to 1e-7 absolute.

One camera is held against grtrans_tpu with its matricant made exact.  At
1e11 Hz the hybrid / lsoda rays cross cells where |rho| >> |a| (909 of the
1984 valid cells have |rho| / |a| > 100, up to 1.4e14, with |rho| dlam up
to 99 rad): there grtrans_tpu's matricant eigenvalue
lam1 = sqrt(rt - (p2 - a2)/2) cancels, and its O is up to 2.2e-7 off
exp(-K dlam) (extended-precision expm), where the port's, taken from the
product lam1 lam2 = |a.rho|, is within 1.1e-14
(test_faraday_thick_cells_take_the_exact_matricant).  The camera's I
spectrum is then 2.1e-9 from grtrans_tpu's, CP 1.1e-7, the orientation
theta 1.6e-7 of itself.  So on that camera (FARADAY_THICK) the reference
is grtrans_tpu's own render with its _calc_O replaced by the
extended-precision expm of each cell (_jax_exact_render), and every bar
above holds against it (measured: I 3e-13, Q, U, V 1e-10 of I, the
moments 6.4e-10); the image bars are also held against grtrans_tpu as it
is.  The same holds from the default uout (see
test_default_uout_agrees_in_intensity).

The cameras start at uout = 0.0025 (r = 400).  With the default
uout = 1e-4 a SARIAF ray begins where theta_e = 0.02, inside the band
where the thermal Faraday fit divides rounding noise by K_2(1/theta_e)
(tests/test_torch_bessel_polsynch.py): XLA's tanh leaves 1.1e-16 there and
grtrans_tpu's rho_V is noise of order 1e3 rad a cell, torch's tanh gives the
exact 0, so Q and U differ by 3.6e-5 of their sums while I agrees to
2.1e-10.  One test renders that default and holds I alone.

The pixel-block and geodesic-reuse options are held against the port's own
plain run: rays are independent, so only the batched elementwise kernels'
roundoff may differ (bar 1e-12 of max|I|)."""

import numpy as np
import pytest
import torch

from grtrans_tpu.api import Grtrans as JGrtrans
from grtrans_tpu.io.binio import read_camera_bin as jread_camera_bin
from grtrans_tpu.io.fitsio import read_fits as jread_fits
from grtrans_tpu_torch.api import Grtrans
from grtrans_tpu_torch.integrate import solvers as tsol
from grtrans_tpu_torch.io.binio import read_camera_bin

from test_torch_solvers import _expm_longdouble, _opacity

torch.set_num_threads(1)   # the suite runs in parallel worker processes

COMMON = dict(spin=0.9, standard=1, nn=(8, 8, 32), mbh=4e6, mumin=0.5,
              mumax=0.5, nfreq=2, fmin=1e11, fmax=1e12,
              gridvals=(-15.0, 15.0, -15.0, 15.0), uout=0.0025)
RIAF = dict(n0=4e7, t0=1.6e11, beta=10.0)
POWERLAW = dict(n0=3e7, t0=6e10, beta=10.0)
CONFIGS = {
    "sariaf_thermal_formal": dict(fname="SARIAF", ename="POLSYNCHTH",
                                  nvals=4, iname="formal", fargs=RIAF),
    "sariaf_hybrid_lsoda": dict(fname="SARIAF", ename="HYBRIDTHPL", nvals=4,
                                iname="lsoda", fargs=RIAF),
    # gmin = 1 keeps R_high = gmin (1 / muval - 1) at 3, so the electrons
    # stay at theta_e ~ 2.5 and the image is lit
    "powerlaw_thermal_delo": dict(fname="POWERLAW", ename="POLSYNCHTH",
                                  nvals=4, iname="delo", gmin=1.0,
                                  fargs=POWERLAW),
    "powerlaw_thermal_delo_unpolarized": dict(
        fname="POWERLAW", ename="POLSYNCHTH", nvals=1, iname="delo",
        gmin=1.0, fargs=POWERLAW),
}


# configurations whose rays cross Faraday-thick cells, where grtrans_tpu's
# matricant cancels (module docstring): their spectra, moments and
# conversions are held against _jax_exact_render
FARADAY_THICK = {"sariaf_hybrid_lsoda"}


def _exact_O(K, dx):
    """exp(-K dx) of every cell by extended-precision scaling and squaring
    (test_torch_solvers): K (..., 7), dx (...) -> (4, 4, ...)."""
    O = _expm_longdouble(-_opacity(K.reshape(-1, 7))
                         * dx.reshape(-1)[:, None, None])
    return np.moveaxis(O.astype(np.float64), 0, -1).reshape(
        (4, 4) + dx.shape)


def _jax_exact_O(a, rho, dx, dx64=None, with_bad=False):
    """grtrans_tpu's _calc_O with every cell's O from _exact_O, called back
    to the host from the traced program."""
    import jax
    import jax.numpy as jnp
    assert not with_bad
    args = jnp.broadcast_arrays(*a, *rho, dx)

    def host(*cols):
        cols = [np.asarray(c, np.float64) for c in cols]
        return _exact_O(np.stack(cols[:7], -1), cols[7]).astype(
            args[-1].dtype)

    out = jax.ShapeDtypeStruct((4, 4) + args[-1].shape, args[-1].dtype)
    return jax.pure_callback(host, out, *args, vmap_method="broadcast_all")


def _jax_exact_render(kw):
    """grtrans_tpu's render of kw with _jax_exact_O as its matricant.  JAX's
    compiled programs and grtrans_tpu's render cache are cleared before,
    so the render traces the patched _calc_O, and after, so that no later
    grtrans_tpu call reuses it."""
    import jax
    from grtrans_tpu import orchestrator as jorch
    from grtrans_tpu.integrate import solvers as jsol

    def clear():
        jax.clear_caches()
        jorch._RENDER_CACHE.clear()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsol, "_calc_O", _jax_exact_O)
        clear()
        try:
            return JGrtrans(**kw).run()
        finally:
            clear()


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(name, the port's render, grtrans_tpu's, and grtrans_tpu's with its
    matricant made exact on FARADAY_THICK, else the same render)."""
    kw = dict(COMMON, **CONFIGS[request.param])
    ref = JGrtrans(**kw).run()
    exact = _jax_exact_render(kw) if request.param in FARADAY_THICK else ref
    return request.param, Grtrans(**kw).run(device="cpu"), ref, exact


def _spec_close(ours, ref):
    """Stokes I to 1e-9 relative, Q, U, V to 1e-7 of the largest I (V of the
    hybrid / lsoda camera at 1e11 Hz differs by 9e-6 of itself, and by
    1.2e-6 between jitted and eager grtrans_tpu)."""
    np.testing.assert_allclose(ours[0], ref[0], rtol=1e-9)
    np.testing.assert_allclose(ours, ref, rtol=1e-9,
                               atol=1e-7 * np.abs(ref[0]).max())


def test_image_matches_jax(pair):
    """Against grtrans_tpu as it is and with its matricant made exact."""
    name, ours, ref, exact = pair
    nvals = CONFIGS[name]["nvals"]
    assert np.isfinite(ours.ivals).all()
    assert ours.ivals[:, 0].max() > 1e-5      # a lit image, not 1e-30
    for ref in (ref,) if exact is ref else (ref, exact):
        assert ours.ivals.shape == ref.ivals.shape == (64, nvals, 2)
        np.testing.assert_array_equal(ours.ab, ref.ab)
        np.testing.assert_array_equal(ours.freqs, ref.freqs)
        rel_l1 = np.abs(ours.ivals - ref.ivals).sum() \
            / np.abs(ref.ivals).sum()
        # DELO leaves negative I in thick pixels: |I| in the denominator
        rel_i = np.abs(ours.ivals[:, 0] - ref.ivals[:, 0]).sum() \
            / np.abs(ref.ivals[:, 0]).sum()
        print(f"{name}: I max {ours.ivals[:, 0].max(0)}, rel L1 "
              f"{rel_l1:.3e}, of I {rel_i:.3e}")
        assert rel_l1 <= 1e-8
        assert rel_i <= 1e-9


def test_spectrum_polarization_and_centroid_match_jax(pair):
    name, ours, _, ref = pair
    _spec_close(ours.spec, ref.spec)
    assert (ours.da, ours.db) == (ref.da, ref.db)
    if CONFIGS[name]["nvals"] == 4:
        for attr in ("lp", "cp", "lpf", "cpf"):
            np.testing.assert_allclose(getattr(ours, attr),
                                       getattr(ref, attr), rtol=1e-6,
                                       atol=1e-7)
        if CONFIGS[name]["iname"] != "delo":
            # DELO at 32 points a ray leaves negative I in thick pixels, in
            # both packages alike
            assert ((0.0 <= ours.lp) & (ours.lp <= 1.0)).all()
    ours.calc_centroid_size()
    ref.calc_centroid_size()
    for attr in ("xcen", "ycen", "amax", "amin", "theta"):
        # second moments cancel against the squared centroid
        np.testing.assert_allclose(getattr(ours, attr), getattr(ref, attr),
                                   rtol=1e-7, atol=1e-9)


def test_unit_conversions_and_binary_output_match_jax(pair, tmp_path):
    name, ours, _, ref = pair
    path = tmp_path / "cams.bin"
    ours.write_output(path, fmt="bin")
    ref.write_output(tmp_path / "ref.bin", fmt="bin")
    assert path.stat().st_size == (tmp_path / "ref.bin").stat().st_size
    ab, cams, keys = jread_camera_bin(path)
    np.testing.assert_allclose(cams, jread_camera_bin(tmp_path / "ref.bin")[1],
                               rtol=1e-6, atol=1e-7 * np.abs(cams).max())
    assert len(cams) == 2 and [float(k[0]) for k in keys] == [
        float(np.float32(f)) for f in ours.freqs]
    np.testing.assert_array_equal(ab, ours.ab.astype(np.float32))
    for i, cam in enumerate(cams):
        np.testing.assert_array_equal(cam,
                                      ours.ivals[:, :, i].astype(np.float32))
    for a, b in zip(read_camera_bin(path)[1], cams):
        np.testing.assert_array_equal(a, b)
    # FITS: the same cameras, and grtrans_tpu's header on each
    ours.write_output(tmp_path / "cams.fits", fmt="fits")
    ref.write_output(tmp_path / "ref.fits", fmt="fits")
    ab, cams, keys, heads = jread_fits(tmp_path / "cams.fits",
                                       with_headers=True)
    _, _, ref_keys, ref_heads = jread_fits(tmp_path / "ref.fits",
                                           with_headers=True)
    np.testing.assert_array_equal(ab, ours.ab.astype(np.float32))
    for i, cam in enumerate(cams):
        np.testing.assert_array_equal(
            cam, ours.ivals[:, :, i].T.ravel().astype(np.float32))
    assert keys == ref_keys and heads == ref_heads and len(heads) == 2

    # conversions act on copies of the fixture's results
    mine, theirs = Grtrans(), JGrtrans()
    for obj, src in ((mine, ours), (theirs, ref)):
        obj.__dict__.update({k: np.copy(v) if isinstance(v, np.ndarray)
                             else v for k, v in src.__dict__.items()})
    _spec_close(mine.convert_to_lum(), theirs.convert_to_lum())
    _spec_close(mine.convert_to_Jy(2.5e22), theirs.convert_to_Jy(2.5e22))
    np.testing.assert_allclose(mine.ivals, theirs.ivals, rtol=1e-9,
                               atol=1e-7 * np.abs(theirs.ivals).max())


@pytest.fixture(scope="module")
def plain():
    kw = dict(COMMON, **CONFIGS["sariaf_hybrid_lsoda"])
    return kw, Grtrans(**kw).run(device="cpu")


def test_pixel_blocks_equal_the_plain_run(plain):
    """chunk=24 cuts 64 pixels into 24 + 24 + 16: the last block is short,
    not padded."""
    kw, whole = plain
    blocks = Grtrans(**kw).run(device="cpu", chunk=24)
    np.testing.assert_array_equal(blocks.ab, whole.ab)
    np.testing.assert_allclose(blocks.ivals, whole.ivals, rtol=0.0,
                               atol=1e-12 * np.abs(whole.ivals).max())
    np.testing.assert_allclose(blocks.spec, whole.spec, rtol=1e-12)


def test_geodesic_reuse_over_an_mdot_scan_equals_the_plain_run(plain,
                                                               tmp_path):
    """nmdot=3 renders three cameras per frequency set from one trace;
    SARIAF does not scale with mdot, so each equals the plain run, in the
    order freq fastest, then mdot; also from a gdfile bundle, traced and
    saved on the first run, loaded on the second."""
    from grtrans_tpu_torch.config import GrtransConfig
    from grtrans_tpu_torch.orchestrator import grtrans_run
    kw, whole = plain
    cfg = GrtransConfig(**dict(kw, nmdot=3, mdotmin=1e14, mdotmax=1e16))
    gd = str(tmp_path / "geo.npz")
    for options in (dict(reuse_geo=True), dict(reuse_geo=True, chunk=24),
                    dict(), dict(gdfile=gd), dict(gdfile=gd, chunk=24)):
        ivals, _, freqs = grtrans_run(cfg, device="cpu", **options)
        assert ivals.shape == (6, 64, 4) and len(freqs) == 2
        for cam in range(6):
            np.testing.assert_allclose(
                ivals[cam].numpy(), whole.ivals[:, :, cam % 2], rtol=0.0,
                atol=1e-12 * np.abs(whole.ivals).max())


def test_default_uout_agrees_in_intensity():
    """uout = 1e-4: the rays start in grtrans_tpu's rho_V noise band (module
    docstring), so only Stokes I is held.  At 1e11 Hz 913 of the 1984
    valid cells have |rho| / |a| > 100, with |rho| dlam up to 2.3e3 rad:
    there grtrans_tpu's matricant is up to 6.3e-6 off the
    extended-precision expm and the port's 3.5e-13
    (test_faraday_thick_cells_take_the_exact_matricant), and grtrans_tpu's
    I spectrum is 6.2e-9 from the port's.  So the reference is
    grtrans_tpu's render with its matricant made exact (_jax_exact_render;
    measured: I spectrum 4.8e-12 from the port's)."""
    kw = dict(COMMON, **CONFIGS["sariaf_thermal_formal"])
    del kw["uout"]
    ours = Grtrans(**kw).run(device="cpu")
    ref = _jax_exact_render(kw)
    rel_i = np.abs(ours.ivals[:, 0] - ref.ivals[:, 0]).sum(0) \
        / ref.ivals[:, 0].sum(0)
    assert (rel_i <= 1e-9).all(), rel_i
    assert np.isfinite(ours.ivals).all()
    np.testing.assert_allclose(ours.spec[0], ref.spec[0], rtol=1e-9)


def test_run_without_a_device_does_not_fall_back_to_the_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: run() would render on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        Grtrans(**dict(COMMON, **CONFIGS["sariaf_thermal_formal"])).run()


def _tiny(**change):
    kw = dict(COMMON, **CONFIGS["sariaf_thermal_formal"])
    kw.update(change, nn=(4, 4, 16))
    return kw


def _snapshot_kw(fname):
    """A seeded synthetic GRMHD snapshot handed to both packages as the
    same numpy dump dict."""
    from grtrans_tpu_torch.testing import grmhd_dump
    dump = grmhd_dump.harm_dump(16, 12) if fname == "HARM" \
        else grmhd_dump.harm3d_dump(16, 12, 8)
    return dict(fname=fname, spin=grmhd_dump.A, uout=0.04, mdotmin=3e15,
                mdotmax=3e15, gmin=10.0, fargs=dict(dump=dump))


def _grtrans_run(**options):
    from grtrans_tpu_torch.config import GrtransConfig
    from grtrans_tpu_torch.orchestrator import grtrans_run
    return grtrans_run(GrtransConfig(**_tiny()), device="cpu", **options)


UNPORTED = {
    "mixed": (NotImplementedError,
              lambda: Grtrans(**_tiny(prec="mixed")).run(device="cpu")),
    # a mesh shards the pixels, chunk bounds one device's memory: refused
    # together, as grtrans_tpu refuses them, before the mesh is looked at
    "mesh": (ValueError, lambda: _grtrans_run(mesh=object(), chunk=8)),
    # a fluid name that neither package knows, as grtrans_tpu raises it
    "HARM2D": (ValueError,
               lambda: Grtrans(**_tiny(fname="HARM2D")).run(device="cpu")),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_options_raise_by_name(name):
    error, call = UNPORTED[name]
    with pytest.raises(error, match=name):
        call()


@pytest.mark.parametrize("change,columns", [
    (dict(fname="THINDISK", ename="BB", standard=2, fargs={}), 4),
    (dict(ename="BB"), 4), (dict(standard=2), 4), (dict(extra=1), 23),
    (dict(debug=1), 4), (dict(nload=2), 4), (_snapshot_kw("HARM"), 4),
    (_snapshot_kw("HARM3D"), 4)],
    ids=["THINDISK", "BB", "standard=2", "extra=1", "debug=1",
         "nload=2 on one slice", "HARM", "HARM3D"])
def test_ported_options_render(change, columns):
    """Options that render, with the shape and Stokes I that grtrans_tpu
    gives them."""
    kw = _tiny(**change)
    ours = Grtrans(**kw).run(device="cpu")
    assert ours.ivals.shape == (16, columns, 2)
    assert np.isfinite(ours.ivals).all()
    ref = JGrtrans(**kw).run()
    assert ours.ivals.shape == ref.ivals.shape
    np.testing.assert_allclose(ours.ivals[:, 0], ref.ivals[:, 0], rtol=1e-7,
                               atol=1e-9 * np.abs(ref.ivals[:, 0]).max())


@pytest.mark.parametrize("name,uout", [("sariaf_hybrid_lsoda", 0.0025),
                                       ("sariaf_thermal_formal", None)])
def test_faraday_thick_cells_take_the_exact_matricant(name, uout):
    """The evidence behind FARADAY_THICK and
    test_default_uout_agrees_in_intensity: on the 1e11 Hz camera's cells
    with |rho| / |a| > 100, the port's O is within 1e-12 of the
    extended-precision expm (of max|O|) and grtrans_tpu's, on the same
    coefficients, is not (more than 1e-9)."""
    from grtrans_tpu.integrate import solvers as jsol
    from grtrans_tpu_torch import driver
    from grtrans_tpu_torch.config import GrtransConfig
    from grtrans_tpu_torch.fluid.base import load_fluid_model
    from grtrans_tpu_torch.geodesics import camera
    from grtrans_tpu_torch.orchestrator import _source_params, trace_camera

    kw = dict(COMMON, **CONFIGS[name])
    if uout is None:
        del kw["uout"]
    cfg = GrtransConfig(**kw)
    a, mu0 = cfg.spin, cfg.mumin
    cam = camera.make_camera(a, mu0, *cfg.gridvals, *cfg.nn[:2],
                             device="cpu")
    geo = trace_camera(cfg, cam, mu0)
    model = load_fluid_model(cfg.fname, device="cpu", **cfg.fargs)
    fv = model.vals(geo.x, geo.k, a)
    sp = _source_params(cfg, float(cfg.mdotmin))
    _, dbg = driver.render_rays(geo, fv, model.convert(fv, sp), cfg.ename,
                                [cfg.fmin], mu0, cam.alpha, cam.beta, a,
                                cfg.mbh, sp, iname=cfg.iname, debug=True)
    K = dbg["K_0"].numpy()
    ok = (dbg["ok"][:, 1:] & dbg["ok"][:, :-1]).numpy()
    Kc = (0.5 * (K[:, 1:] + K[:, :-1]))[ok]
    dl = np.diff(dbg["lam"].numpy(), axis=-1)[ok]
    ratio = np.linalg.norm(Kc[:, 4:], axis=-1) \
        / np.maximum(np.linalg.norm(Kc[:, 1:4], axis=-1), 1e-300)
    thick = ratio > 1e2
    Kc, dl = Kc[thick], dl[thick]
    ref = _exact_O(Kc, dl)
    kt = torch.tensor(Kc)
    ours = tsol._calc_O(tuple(kt[:, :4].T), tuple(kt[:, 4:].T),
                        torch.tensor(dl))
    theirs = np.asarray(jsol._calc_O(tuple(Kc[:, :4].T), tuple(Kc[:, 4:].T),
                                     dl))
    scale = np.abs(ref).max((0, 1))
    err_ours = (np.abs(ours.numpy() - ref).max((0, 1)) / scale).max()
    err_theirs = (np.abs(theirs - ref).max((0, 1)) / scale).max()
    print(f"{name}: {thick.sum()} of {ok.sum()} cells with |rho|/|a| > 100 "
          f"(max {ratio.max():.3g}, |rho| dlam up to "
          f"{(np.linalg.norm(Kc[:, 4:], axis=-1) * dl).max():.3g} rad); "
          f"O off the exact matricant: port {err_ours:.2e}, grtrans_tpu "
          f"{err_theirs:.2e}")
    assert thick.sum() > 0
    assert err_ours <= 1e-12 < 1e-9 < err_theirs
