"""The port's multi-GPU paths on 4 gloo processes of the CPU: pixel
sharding through grtrans_run(mesh=) and parallel/sharding.py, and the
theta-slab-sharded GRMHD sampler (fluid/grmhd3d.py sample_sharded), against
the port's run in one process and against grtrans_tpu's shard_map on 4 of
its 8 virtual CPU devices (tests/conftest.py).

One module fixture spawns the 4 processes once through
grtrans_tpu_torch.parallel.dryrun (whose processes import no JAX), has
them run every check of dryrun.CHECKS, and meanwhile renders each check's
reference in this process without a mesh; each test asserts one result.

Bars: a sharded image against the run in one process rtol 1e-12, atol 0
(tests/test_sharding.py holds grtrans_tpu against itself so), the spectrum
1e-12; sample_sharded's FluidVars against grtrans_tpu's shard_map
sample_sharded and the sharded image against grtrans_tpu's at the bars of
tests/test_torch_grmhd.py (vals 1e-12 of max|ref|; image relative L1
1e-8, on Stokes I and on IQUV of the rays free of grtrans_tpu's rho_V
noise); the halo, the shard shape and host_pixel_slice exactly.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from grtrans_tpu import driver as jdriver
from grtrans_tpu.config import GrtransConfig as JConfig
from grtrans_tpu.fluid import grmhd3d as jgrmhd3d
from grtrans_tpu.fluid.base import SourceParams as JSourceParams
from grtrans_tpu.orchestrator import grtrans_run as jrun
from grtrans_tpu.parallel import sharding as jsharding
from grtrans_tpu_torch.fluid.base import SourceParams
from grtrans_tpu_torch.orchestrator import grtrans_run
from grtrans_tpu_torch.parallel import dryrun, sharding
from grtrans_tpu_torch.testing import grmhd_dump as gd

from test_torch_grmhd import A, MU0, both, close, jax_bundle, rays

torch.set_num_threads(1)   # the suite runs in parallel worker processes

NPROC = 4
CPU = torch.device("cpu")
SP = dict(mbh=4.3e6, mdot=3e15, mu=0.25, gmin=10.0)
IMAGE_RTOL = 1e-8          # tests/test_torch_grmhd.py check_image


@contextlib.contextmanager
def world_of_one():
    """A gloo world of one in this process (pixel_mesh without a group),
    destroyed on the way out so that no other test sees it."""
    assert not dist.is_initialized()
    try:
        yield sharding.pixel_mesh(device_type="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _jax_shard_map(f, in_specs, out_specs):
    """f under shard_map on 4 devices, jitted (shard_map run eagerly takes
    minutes an op at a time)."""
    return jax.jit(jax.shard_map(f, mesh=jsharding.pixel_mesh(NPROC),
                                 in_specs=in_specs, out_specs=out_specs))


def _jax_snapshot():
    """grtrans_tpu's HARM3D model on the snapshot of dryrun._harm3d, its
    theta-sharded stack on 4 devices and the port's geodesics of the
    8x8 x 32 camera of dryrun.check_sample_sharded."""
    dump = gd.harm3d_dump(16, 3 * NPROC, 8, seed=0)
    jmodel, tmodel = both("HARM3D", dump)
    grid, _ = jmodel.stacked_grid(jnp.float64)
    spec = jsharding.snapshot_shard_spec(jsharding.pixel_mesh(NPROC),
                                         grid.ndim, axis=2)
    return jmodel, tmodel, jax.device_put(grid, spec)


def _jax_references():
    """grtrans_tpu's sharded sample and sharded image, its halo pattern
    and its theta shard shape, on 4 of the 8 virtual devices."""
    jmodel, tmodel, gsh = _jax_snapshot()
    cam, geo = rays()
    slab = P(None, None, "pix", None, None)
    fv = _jax_shard_map(
        lambda g, x: jgrmhd3d.sample_sharded(jmodel, x, A, g),
        (slab, P("pix")), P("pix"))(gsh, jnp.asarray(geo.x.numpy()))
    jsp = JSourceParams(**SP)

    def render(g, bundle, alpha, beta):
        f = jgrmhd3d.sample_sharded(jmodel, bundle.x, A, g)
        return jdriver.render_rays(bundle, f, jmodel.convert(f, jsp),
                                   "POLSYNCHTH", [2.3e11], MU0, alpha, beta,
                                   A, SP["mbh"], jsp, iname="formal",
                                   nvals=4)

    image = _jax_shard_map(render, (slab, P("pix"), P("pix"), P("pix")),
                           P(None, "pix"))(
        gsh, jax_bundle(geo), jnp.asarray(cam.alpha.numpy()),
        jnp.asarray(cam.beta.numpy()))
    nth = 8 * NPROC
    grid = jnp.arange(nth, dtype=jnp.float64)[:, None] * jnp.ones((1, 4))
    halo = _jax_shard_map(
        lambda b: jnp.stack(jsharding.halo_exchange_theta(b))[None],
        P("pix"), P("pix"))(grid)
    shape = jsharding.snapshot_shard_spec(
        jsharding.pixel_mesh(NPROC), 4, axis=2).shard_shape((3, 16, nth, 10))
    return dict(fv=fv, image=np.asarray(image), halo=np.asarray(halo),
                shard_shape=tuple(shape), tmodel=tmodel)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(each process's results, the port's references in one process,
    grtrans_tpu's references)."""
    work = str(tmp_path_factory.mktemp("ranks"))
    ranks = dryrun.launch(NPROC, "cpu", work)
    try:
        refs = {name: check(CPU, None, NPROC, work)
                for name, check in dryrun.CHECKS.items()}
        jref = _jax_references()
    except BaseException:
        ranks.kill()
        raise
    return ranks.join(), refs, jref


def _every_rank(run, name):
    results, refs, _ = run
    return [res[name] for res in results], refs[name]


@pytest.mark.parametrize("name", ["sariaf", "extra_subrange",
                                  "device_output", "harm3d_mdots",
                                  "harm3d_slow_light", "standard2"])
def test_grtrans_run_mesh_equals_one_process(run, name):
    """SARIAF at two inclinations; with extra=1 on an i1..i2 cut of the
    camera; as the list of device_output; HARM3D with two accretion rates
    from one trace (reuse_geo); HARM3D slow light on three slices of a
    brightening series, which holds the delays' minimum to the whole
    camera's; thin-disk imaging (standard=2).  The whole image on every
    process."""
    outs, ref = _every_rank(run, name)
    assert torch.isfinite(ref).all() and ref[..., 0].max() > 0
    for out in outs:
        torch.testing.assert_close(out, ref, rtol=1e-12, atol=0.0)


def test_render_sharded_and_spectrum_all_reduce(run):
    outs, (image, flux) = _every_rank(run, "spectrum")
    for out_image, out_flux in outs:
        torch.testing.assert_close(out_image, image, rtol=1e-12, atol=0.0)
        torch.testing.assert_close(out_flux, flux, rtol=1e-12, atol=0.0)


def test_gdfile_under_a_mesh_writes_the_bundle_of_one_process(run):
    """The run that saves and the run that loads give the image of one
    process, and the file holds that run's bundle under the same key."""
    outs, (images, path) = _every_rank(run, "gdfile")
    for out_images, out_path in outs:
        for out in out_images:
            torch.testing.assert_close(out, images[0], rtol=1e-12, atol=0.0)
    with np.load(outs[0][1]) as ours, np.load(path) as ref:
        assert sorted(ours.files) == sorted(ref.files)
        assert ours["_key"].tobytes() == ref["_key"].tobytes()
        for f in ref.files:
            np.testing.assert_allclose(ours[f], ref[f], rtol=1e-12, atol=0,
                                       err_msg=f)


def test_sample_sharded_matches_replicated_and_jax(run):
    outs, ref = _every_rank(run, "sample_sharded")
    jfv = run[2]["fv"]
    for out in outs:
        assert out.keys() == ref.keys()
        for f, v in ref.items():
            close(f, out[f], v.numpy(), 1e-14)
    for f in ("rho", "p", "bmag", "u", "b"):
        close(f, outs[0][f], getattr(jfv, f), 1e-12)


def test_sharded_render_matches_replicated_and_jax(run):
    outs, ref = _every_rank(run, "sharded_render")
    for out in outs:
        torch.testing.assert_close(out, ref, rtol=1e-12, atol=0.0)
    jimage, tmodel = run[2]["image"], run[2]["tmodel"]
    ours = outs[0].numpy()
    assert ours.shape == jimage.shape == (1, 64, 4)
    rel_i = (np.abs(ours[..., 0] - jimage[..., 0]).sum()
             / np.abs(jimage[..., 0]).sum())
    assert rel_i <= IMAGE_RTOL, rel_i
    # the rays that never cross 1e-2 < theta_e < 0.1, as check_image holds
    _, geo = rays()
    tei = tmodel.convert(tmodel.vals(geo.x, geo.k, A), SourceParams(**SP))
    thetae = tei.tcgs * 1.38e-16 / (9.10938188e-28 * 2.99792458e10 ** 2)
    cold = ((thetae > 1e-2) & (thetae < 0.1) & (tei.ncgs > 0)).any(-1)
    warm = ~cold.numpy()
    assert warm.any()
    rel = (np.abs(ours[0, warm] - jimage[0, warm]).sum()
           / np.abs(jimage[0, warm]).sum())
    assert rel <= IMAGE_RTOL, rel


def test_halo_exchange_matches_jax(run):
    """Blocks of 8 rows of arange(32): the edges take their own boundary
    row, the two interior processes their neighbours' (the pattern of
    tests/test_sharding.py::test_halo_exchange_theta)."""
    outs, _ = _every_rank(run, "halo")
    np.testing.assert_array_equal(torch.stack(outs).numpy(), run[2]["halo"])


def test_shard_shape_matches_jax(run):
    outs, _ = _every_rank(run, "shard_shape")
    assert run[2]["shard_shape"] == (3, 16, 8, 10)
    assert all(out == run[2]["shard_shape"] for out in outs)


def test_host_pixel_slice_matches_jax():
    for npix in (0, 1, 10, 1000, 1001):
        for count in (1, 3, 4, 7):
            for pid in range(count):
                assert sharding.host_pixel_slice(npix, pid, count) \
                    == jsharding.host_pixel_slice(npix, pid, count)
    assert sharding.host_pixel_slice(10) == (0, 10)


def test_uneven_pixel_counts_are_refused_as_in_jax(run):
    """jax.device_put with P("pix") refuses a pixel count the mesh does not
    divide, and so grtrans_tpu's grtrans_run(mesh=); the port refuses both
    on every process, before any collective."""
    jmesh = jsharding.pixel_mesh(NPROC)
    with pytest.raises(ValueError, match="divisible"):
        jsharding.shard_pixels(jmesh, np.arange(4 * NPROC + 2.0))
    cfg = jax_config(dryrun._config(nn=(2 * NPROC + 1,) * 2 + (8,)))
    with pytest.raises(ValueError, match="divisible"):
        jrun(cfg, mesh=jmesh)
    for res in run[0]:
        for call in ("shard_pixels", "grtrans_run"):
            kind, msg = res["refusals"][call]
            assert kind == "ValueError" and "divisible" in msg, (call, msg)


def test_a_device_not_the_process_s_is_refused(run):
    for res in run[0]:
        kind, msg = res["refusals"]["device"]
        assert kind == "ValueError" and "not this process's device" in msg


def test_mesh_with_chunk_raises_in_both_packages():
    cfg = dryrun._config()
    with pytest.raises(ValueError, match="mesh"):
        jrun(jax_config(cfg), mesh=jsharding.pixel_mesh(NPROC),
             chunk=8)
    with world_of_one() as mesh, pytest.raises(ValueError, match="mesh"):
        grtrans_run(cfg, device="cpu", mesh=mesh, chunk=8)


def test_world_of_one_sample_sharded_is_vals():
    """One process holds the whole grid as its slab: its halo is its own
    last row, and sample_sharded is vals."""
    tmodel = dryrun._harm3d(CPU, NPROC)
    _, geo = rays()
    ref = tmodel.vals(geo.x, geo.k, A)
    from grtrans_tpu_torch.fluid.grmhd3d import sample_sharded
    with world_of_one() as mesh:
        grid, _ = tmodel.stacked_grid()
        ours = sample_sharded(tmodel, geo.x, A, grid, mesh)
        again = sample_sharded(tmodel, geo.x, A, grid, mesh)
    for f in ("rho", "p", "bmag", "u", "b"):
        close(f, getattr(ours, f), getattr(ref, f).numpy(), 1e-14)
        assert torch.equal(getattr(again, f), getattr(ours, f))


def test_slab_samples_sum_to_the_whole_gather():
    """slab_sample on virtual slabs of one process: the slabs' columns sum
    to _gather_cols on the whole table, and each slab's are zero where it
    holds no cell."""
    from grtrans_tpu_torch.fluid.grmhd3d import slab_sample, slab_table
    tmodel = dryrun._harm3d(CPU, NPROC)
    _, geo = rays()
    q = tmodel._query(geo.x, A)
    table, names = tmodel._stacked_fields()
    nx2, nx3 = tmodel.uniqx2.shape[0], tmodel.uniqx3.shape[0]
    whole = tmodel._gather_cols(table, table.shape[0], nx2, nx3, q,
                                len(names))
    grid, _ = tmodel.stacked_grid()
    B = nx2 // NPROC
    total = torch.zeros_like(whole)
    for s in range(NPROC):
        lo, hi = s * B, (s + 1) * B
        part = slab_sample(tmodel, q, slab_table(
            grid[:, :, lo:hi], grid[:, :, min(hi, nx2 - 1)]), lo, B)
        owned = (q["lx2"] >= lo) & (q["lx2"] < hi)
        assert (part[~owned] == 0).all()
        total += part
    close("slab columns", total, whole.numpy(), 1e-14)


def test_dryrun_part_c_waits_for_gradients():
    with pytest.raises(NotImplementedError, match="part \\(c\\)"):
        dryrun.main(["--nproc", "1", "--device", "cpu", "--parts", "c"])


def jax_config(cfg):
    """grtrans_tpu's GrtransConfig of the port's."""
    return JConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)})
