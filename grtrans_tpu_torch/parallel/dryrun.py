"""Dry run of the port's multi-GPU paths on N processes, one a device: the
counterpart of grtrans_tpu's __graft_entry__.dryrun_multichip.

    python -m grtrans_tpu_torch.parallel.dryrun --nproc 4 --device cpu
    python -m grtrans_tpu_torch.parallel.dryrun --nproc 8 --device cuda

  (a) grtrans_run(mesh=) of a SARIAF config (two inclinations) equals the
      run without a mesh;
  (b) a HARM3D snapshot from testing/grmhd_dump.py, sharded over theta,
      feeds sample_sharded through a full IQUV render, equal to the
      replicated render;
  (c) the gradient through the sharded render waits for gradients in the
      port and raises NotImplementedError.

The parent spawns the processes (torch.multiprocessing, "spawn"); each
joins a process group through a FileStore in a temporary directory (no
port to collide on), runs its checks and saves their results there.  The
parent renders the references without a mesh meanwhile, joins the
processes with a timeout, kills any that outlive it, and raises if a
process failed or a result differs.  tests/test_torch_sharding.py runs
every check of CHECKS through `launch` on 4 gloo processes.

Importing this module starts no process and opens no group.
"""

import argparse
import os
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp

RTOL = 1e-12          # a sharded image against the run without a mesh
SPIN = 0.9
MU0 = 0.5


def _side(nproc, least):
    """The least camera side >= least whose square nproc divides."""
    side = least
    while (side * side) % nproc:
        side += 1
    return side


def _config(**change):
    from grtrans_tpu_torch.config import GrtransConfig
    kw = dict(fname="SARIAF", ename="POLSYNCHTH", nvals=4, spin=SPIN,
              standard=1, nn=(4, 4, 16), mumin=MU0, mumax=MU0, nmu=1,
              nfreq=1, fmin=2.3e11, fmax=2.3e11, iname="formal", mbh=4e6,
              gridvals=(-12.0, 12.0, -12.0, 12.0),
              fargs=dict(n0=4e7, t0=1.6e11, beta=10.0))
    kw.update(change)
    return GrtransConfig(**kw)


def _harm3d_config(nn, **change):
    from grtrans_tpu_torch.testing import grmhd_dump
    return _config(**dict(dict(
        fname="HARM3D", spin=grmhd_dump.A, nn=nn, uout=0.04, mbh=4.3e6,
        mdotmin=3e15, mdotmax=3e15, gmin=10.0, muval=0.25, fargs={}),
        **change))


def _harm3d(device, nproc, seed=0):
    """The seeded synthetic HARM3D snapshot, 3 nproc theta rows."""
    from grtrans_tpu_torch.fluid.base import load_fluid_model
    from grtrans_tpu_torch.testing import grmhd_dump
    return load_fluid_model("HARM3D", device=device, dump=grmhd_dump
                            .harm3d_dump(16, 3 * nproc, 8, seed=seed))


def _run(cfg, device, mesh, model=None, **kw):
    from grtrans_tpu_torch.orchestrator import grtrans_run
    return grtrans_run(cfg, model, device=device, mesh=mesh, **kw)[0]


# Each check renders with mesh=None (the reference, in one process) or on
# every process of the mesh; nproc sizes the problem for the mesh.

def check_sariaf(device, mesh, nproc, work):
    """Part (a): SARIAF at two inclinations."""
    side = _side(nproc, 4)
    return _run(_config(nn=(side, side, 16), nmu=2, mumin=0.3, mumax=0.7),
                device, mesh)


def check_extra_subrange(device, mesh, nproc, work):
    """SARIAF with extra=1 (19 more columns) on the pixels i1..i2 of a
    larger camera: the cut comes before the blocks."""
    side = _side(nproc, 4) + 1
    count = (side * side - 2) // nproc * nproc       # pixels 2 .. count + 1
    return _run(_config(nn=(side, side, 16), extra=1, i1=2, i2=count + 1),
                device, mesh)


def check_device_output(device, mesh, nproc, work):
    """device_output=True: the list of each render's whole image (two
    inclinations), stacked here."""
    side = _side(nproc, 4)
    cfg = _config(nn=(side, side, 16), nmu=2, mumin=0.3, mumax=0.7)
    images = _run(cfg, device, mesh, device_output=True)
    if not isinstance(images, list) or len(images) != 2:
        raise TypeError(f"device_output gave {type(images)}")
    return torch.stack(images)


def check_harm3d_mdots(device, mesh, nproc, work):
    """HARM3D at 16x16 x 24, two accretion rates from one trace."""
    cfg = _harm3d_config((16, 16, 24), nmdot=2, mdotmax=6e15)
    return _run(cfg, device, mesh, _harm3d(device, nproc), reuse_geo=True)


def check_harm3d_slow_light(device, mesh, nproc, work):
    """HARM3D slow light on three slices of a brightening series: each
    block measured from its own least delay would sample other epochs."""
    from grtrans_tpu_torch.fluid.grmhd3d import FIELDS
    model = _harm3d(device, nproc)
    base = {k: model.f[k][0] for k in FIELDS}
    for fac in (1.5, 2.0):
        arrs = {k: v * fac if k in ("rho", "p") else v
                for k, v in base.items()}
        arrs.update({k: base[k] * fac ** 0.5
                     for k in ("b0", "br", "bth", "bph")})
        model.append_slice(arrs)
    model.tstep, model.toffset = 20.0, -40.0
    return _run(_harm3d_config((8, 8, 32), nload=3), device, mesh, model)


def check_standard2(device, mesh, nproc, work):
    """Thin-disk imaging (standard=2) at two frequencies."""
    side = _side(nproc, 8)
    cfg = _config(fname="THINDISK", ename="BBPOL", standard=2,
                  nn=(side, side, 1), uout=0.01, mbh=10.0, mumin=0.26,
                  mumax=0.26, nfreq=2, fmin=2.41e16, fmax=6.31e18,
                  gridvals=(-21.0, 21.0, -21.0, 21.0),
                  fargs=dict(mbh=10.0, mdot=0.1))
    return _run(cfg, device, mesh)


def _strip(alpha, beta, l, q2, sm, u0, device):
    """The Stokes image (npix, 4) of a SARIAF strip camera's pixels."""
    from grtrans_tpu_torch import driver
    from grtrans_tpu_torch.fluid.base import SourceParams, load_fluid_model
    from grtrans_tpu_torch.geodesics import geokerr
    model = load_fluid_model("SARIAF", device=device, n0=4e7, t0=1.6e11,
                             beta=10.0)
    sp = SourceParams(mbh=4e6)
    geo = geokerr.trace(SPIN, MU0, alpha, beta, l, q2, sm, u0, 32)
    fv = model.vals(geo.x, geo.k, SPIN)
    return driver.render_rays(geo, fv, model.convert(fv, sp), "POLSYNCHTH",
                              [2.3e11], MU0, alpha, beta, SPIN, 4e6, sp,
                              iname="formal", nvals=4)[0]


def check_spectrum(device, mesh, nproc, work):
    """A strip camera of 8 nproc pixels through render_sharded, and its
    total flux: each process's sum, all-reduced."""
    from grtrans_tpu_torch.geodesics import camera
    from grtrans_tpu_torch.parallel import sharding
    cam = camera.make_camera(SPIN, MU0, -12.0, 12.0, 0.0, 0.0, 8 * nproc, 1,
                             device=device)
    rays = (cam.alpha, cam.beta, cam.l, cam.q2, cam.sm)
    if mesh is None:
        image = _strip(*rays, cam.u0, device)
        return image, image[:, 0].sum()
    image = sharding.render_sharded(_strip, mesh, rays, cam.u0, device)
    block = _strip(*sharding.shard_pixels(mesh, *rays), cam.u0, device)
    return image, sharding.all_reduce(mesh, block[:, 0].sum())


def check_gdfile(device, mesh, nproc, work):
    """gdfile: a run that traces and saves the bundle, then one that loads
    it; the bundle is the file of the run without a mesh."""
    side = _side(nproc, 4)
    cfg = _config(nn=(side, side, 16))
    path = os.path.join(work, "mesh" if mesh is not None else "plain",
                        "geo.npz")
    return [_run(cfg, device, mesh, gdfile=path) for _ in range(2)], path


def check_sample_sharded(device, mesh, nproc, work, render=False):
    """A theta-sharded HARM3D snapshot sampled through sample_sharded on
    an 8x8 x 32 camera: each FluidVars field, whole; with render, the
    Stokes image of that sample instead.  Without a mesh, Grmhd3D.vals."""
    from torch.distributed.tensor import distribute_tensor

    from grtrans_tpu_torch import driver
    from grtrans_tpu_torch.fluid.base import SourceParams
    from grtrans_tpu_torch.fluid.grmhd3d import sample_sharded
    from grtrans_tpu_torch.geodesics import camera, geokerr
    from grtrans_tpu_torch.parallel import sharding
    from grtrans_tpu_torch.testing import grmhd_dump
    a = grmhd_dump.A
    model = _harm3d(device, nproc)
    cam = camera.make_camera(a, MU0, -12.0, 12.0, -12.0, 12.0, 8, 8,
                             device=device)
    rays = (cam.alpha, cam.beta, cam.l, cam.q2, cam.sm)
    if mesh is not None:
        rays = sharding.shard_pixels(mesh, *rays)
    geo = geokerr.trace(a, MU0, *rays, cam.u0, 32, uout=0.04)
    if mesh is None:
        fv = model.vals(geo.x, geo.k, a)
    else:
        grid, _ = model.stacked_grid()
        block = distribute_tensor(
            grid, mesh, sharding.snapshot_shard_spec(mesh, grid.ndim, 2),
            src_data_rank=None)
        fv = sample_sharded(model, geo.x, a, block, mesh)
    if not render:
        fields = {k: v for k, v in fv._asdict().items()
                  if torch.is_tensor(v)}
        if mesh is None:
            return fields
        return {k: sharding.gather_pixels(mesh, v) for k, v in fields.items()}
    sp = SourceParams(mbh=4.3e6, mdot=3e15, mu=0.25, gmin=10.0)
    image = driver.render_rays(geo, fv, model.convert(fv, sp), "POLSYNCHTH",
                               [2.3e11], MU0, rays[0], rays[1], a, 4.3e6,
                               sp, iname="formal", nvals=4)
    return image if mesh is None else sharding.gather_pixels(mesh, image, 1)


def check_sharded_render(device, mesh, nproc, work):
    """Part (b): trace, sample_sharded, convert and the IQUV march."""
    return check_sample_sharded(device, mesh, nproc, work, render=True)


def check_halo(device, mesh, nproc, work):
    """halo_exchange_theta of blocks of 8 rows of arange(8 nproc): each
    process's (lo_ghost, hi_ghost)."""
    from grtrans_tpu_torch.parallel import sharding
    if mesh is None:
        return None
    grid = torch.arange(8 * nproc, dtype=torch.float64, device=device)
    grid = grid[:, None] * torch.ones(4, dtype=torch.float64, device=device)
    return torch.stack(sharding.halo_exchange_theta(
        sharding.shard_pixels(mesh, grid)[0], mesh))


def check_shard_shape(device, mesh, nproc, work):
    """The local shape of a (3, 16, 8 nproc, 10) grid placed by
    snapshot_shard_spec."""
    from torch.distributed.tensor import distribute_tensor

    from grtrans_tpu_torch.parallel import sharding
    if mesh is None:
        return None
    grid = torch.zeros(3, 16, 8 * nproc, 10, dtype=torch.float64,
                       device=device)
    spec = sharding.snapshot_shard_spec(mesh, grid.ndim, axis=2)
    return tuple(distribute_tensor(grid, mesh, spec,
                                   src_data_rank=None).to_local().shape)


def check_refusals(device, mesh, nproc, work):
    """What a mesh refuses, on every process before any collective: a
    pixel count the mesh does not divide (shard_pixels, grtrans_run), a
    device that is not the process's."""
    from grtrans_tpu_torch.parallel import sharding
    if mesh is None:
        return None
    calls = {
        "shard_pixels": lambda: sharding.shard_pixels(
            mesh, torch.arange(4 * nproc + 2.0, device=device)),
        "grtrans_run": lambda: _run(_config(nn=(2 * nproc + 1,) * 2 + (8,)),
                                    device, mesh),
        "device": lambda: _run(_config(), "cuda:7" if device.type == "cpu"
                               else "cpu", mesh)}
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except Exception as e:     # the refusal is the result
            out[name] = (type(e).__name__, str(e))
    return out


CHECKS = {"sariaf": check_sariaf, "extra_subrange": check_extra_subrange,
          "device_output": check_device_output,
          "harm3d_mdots": check_harm3d_mdots,
          "harm3d_slow_light": check_harm3d_slow_light,
          "standard2": check_standard2, "spectrum": check_spectrum,
          "gdfile": check_gdfile, "sample_sharded": check_sample_sharded,
          "sharded_render": check_sharded_render, "halo": check_halo,
          "shard_shape": check_shard_shape, "refusals": check_refusals}
PARTS = {"a": "sariaf", "b": "sharded_render"}


def _rank_main(rank, nproc, device, work, names, timeout):
    """One process of the run: join the group, run the checks `names` in
    order, save {name: result} (or the traceback of the first check that
    raised, after which the group may be broken) to work/rank<r>.pt."""
    from grtrans_tpu_torch.parallel import sharding
    if device == "cpu":
        # nproc processes share the host's cores
        torch.set_num_threads(1)
    results = {}
    try:
        sharding.init_distributed(
            "file://" + os.path.join(work, "store"), nproc, rank,
            device_type=device, timeout=timeout)
        mesh = sharding.pixel_mesh(nproc, device_type=device)
        dev = sharding.mesh_device(mesh)
        for name in names:
            out = CHECKS[name](dev, mesh, nproc, work)
            results[name] = _to_cpu(out)
    except Exception:
        results["error"] = traceback.format_exc()
    finally:
        torch.save(results, os.path.join(work, f"rank{rank}.pt"))
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _to_cpu(out):
    if torch.is_tensor(out):
        return out.cpu()
    if isinstance(out, (list, tuple)):
        return type(out)(_to_cpu(v) for v in out)
    if isinstance(out, dict):
        return {k: _to_cpu(v) for k, v in out.items()}
    return out


class Ranks:
    """The processes of one run (launch)."""

    def __init__(self, procs, work, deadline):
        self.procs, self.work, self.deadline = procs, work, deadline

    def kill(self):
        """Kill every process still running."""
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()

    def join(self):
        """Each process's results, in rank order.  Processes still alive
        at the deadline are killed and TimeoutError is raised; a process
        that failed raises RuntimeError with its traceback."""
        for p in self.procs:
            p.join(max(self.deadline - time.monotonic(), 0.0))
        late = [r for r, p in enumerate(self.procs) if p.is_alive()]
        self.kill()
        if late:
            raise TimeoutError(f"dry run: ranks {late} still running at "
                               "the deadline; killed")
        results = []
        for r, p in enumerate(self.procs):
            path = os.path.join(self.work, f"rank{r}.pt")
            if p.exitcode != 0 or not os.path.exists(path):
                raise RuntimeError(f"dry run: rank {r} exited with "
                                   f"{p.exitcode}")
            res = torch.load(path, weights_only=False)
            if "error" in res:
                raise RuntimeError(f"dry run: rank {r} failed:\n"
                                   f"{res['error']}")
            results.append(res)
        return results


def launch(nproc, device, work, names=tuple(CHECKS), timeout=60.0,
           deadline=300.0):
    """Start nproc processes that run the checks `names` on a mesh of
    `device` ("cpu": gloo; "cuda": NCCL, a card a process) with the
    group's collective timeout `timeout` s; `work` is a directory for the
    store and the results.  Returns Ranks, whose join() waits at most
    `deadline` s from now."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, nproc, device, str(work), tuple(names),
                               timeout))
             for r in range(nproc)]
    for p in procs:
        p.start()
    return Ranks(procs, str(work), time.monotonic() + deadline)


def max_rel(ours, ref):
    """max|ours - ref| / max|ref|."""
    return ((ours - ref).abs().max() / ref.abs().max()).item()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--parts", default="ab",
                    help="which of the parts a, b, c to run")
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="seconds a collective may wait")
    args = ap.parse_args(argv)
    if "c" in args.parts:
        raise NotImplementedError(
            "dry run part (c), the gradient through the sharded render, "
            "waits for gradients in the port (ROADMAP Queue 1 item 4)")
    names = [PARTS[p] for p in args.parts]
    if args.device == "cuda" and torch.cuda.device_count() < args.nproc:
        raise RuntimeError(f"--nproc {args.nproc} needs as many cards; "
                           f"{torch.cuda.device_count()} visible")
    ref_device = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    with tempfile.TemporaryDirectory() as work:
        ranks = launch(args.nproc, args.device, work, names, args.timeout)
        try:
            refs = {n: CHECKS[n](ref_device, None, args.nproc, work)
                    for n in names}
        except BaseException:
            ranks.kill()
            raise
        results = ranks.join()
    for name in names:
        for r, res in enumerate(results):
            err = max_rel(res[name], refs[name].cpu())
            print(f"dryrun part {name} rank {r}: max rel err {err:.3e} "
                  f"(bar {RTOL})")
            if not err <= RTOL:
                raise AssertionError(f"{name}, rank {r}: {err}")
    print(f"dryrun ({args.nproc} x {args.device}): ok")


if __name__ == "__main__":
    main()
