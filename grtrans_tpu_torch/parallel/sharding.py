"""Multi-GPU scaling: the camera's pixel axis sharded over a 1-D device mesh.

Port of grtrans_tpu/parallel/sharding.py onto torch.distributed.  Rays are
independent, so every process renders a contiguous block of the camera's
pixels with no communication in the render itself; the image is gathered
at the end, and cross-pixel reductions (the slow-light epoch, spectra) are
all-reduces.  The idiom is PyTorch's: one process a device (`torchrun
--nproc-per-node N`, or torch.multiprocessing as parallel/dryrun.py does),
a process group over NCCL for "cuda" and gloo for "cpu", and a 1-D
DeviceMesh whose one dimension is named "pix".  Nothing falls back: on
"cuda" the backend is NCCL or the call raises.

Snapshots too large to replicate shard over theta (`snapshot_shard_spec`):
each process holds a slab of theta rows, and the trilinear sample of a
slab needs the one row after it, which `halo_exchange_theta` brings from
the next process (fluid/grmhd3d.py `sample_sharded`).

Importing this module starts no process and opens no group.
"""

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Shard

MESH_DIM = "pix"
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     *, device_type="cuda", timeout=60.0):
    """Join the process group of this run, once (a second call returns).

    coordinator: rank 0's address, "host:port" (a TCP store) or a URL
    that torch.distributed takes as init_method ("file:///path" for a
    FileStore); with it, num_processes and process_id are the world size
    and this process's rank.  Without any of the three, torchrun's
    environment (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT) is read, and
    where it is not set this process is a world of one.

    The backend is NCCL for device_type "cuda" (each process on the card
    LOCAL_RANK names, else its rank modulo the cards it sees) and gloo for
    "cpu".  timeout (seconds) bounds every collective: a rank that dies or
    raises alone makes the others fail after it instead of hanging."""
    if dist.is_initialized():
        return
    backend = BACKENDS.get(device_type)
    if backend is None:
        raise ValueError(f"device_type {device_type!r}: not one of "
                         f"{sorted(BACKENDS)}")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("torch.distributed has no NCCL: the port's "
                           "multi-GPU path does not fall back to gloo")
    kw = dict(backend=backend, timeout=datetime.timedelta(seconds=timeout))
    if coordinator is not None or num_processes is not None:
        if coordinator is None or num_processes is None or process_id is None:
            raise ValueError("coordinator, num_processes and process_id "
                             "go together")
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        kw.update(init_method=url, world_size=int(num_processes),
                  rank=int(process_id))
        local = os.environ.get("LOCAL_RANK", process_id)
    elif "WORLD_SIZE" in os.environ:
        kw.update(init_method="env://")
        local = os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0))
    else:
        kw.update(store=dist.HashStore(), world_size=1, rank=0)
        local = 0
    if backend == "nccl":
        card = torch.device("cuda", int(local) % torch.cuda.device_count())
        torch.cuda.set_device(card)
        kw.update(device_id=card)
    dist.init_process_group(**kw)


def pixel_mesh(n_devices=None, device_type="cuda"):
    """The 1-D "pix" DeviceMesh over every process of the world, one device
    each; in a process that has joined no group, a world of one
    (init_distributed()).  n_devices, where given, must be the world size:
    a process is a device here, so a mesh over part of the world would
    leave processes out of every render."""
    init_distributed(device_type=device_type)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"pixel_mesh({n_devices}): the world has {world} "
                         "processes, one a device")
    return init_device_mesh(device_type, (world,),
                            mesh_dim_names=(MESH_DIM,))


def multihost_mesh(device_type="cuda"):
    """The pixel mesh over all processes of every host (call after
    init_distributed).  Ranks are numbered host by host, so each host's
    processes hold contiguous pixel blocks (host_pixel_slice)."""
    return pixel_mesh(device_type=device_type)


def host_pixel_slice(npix, process_id=None, process_count=None):
    """The [lo, hi) pixel range of process `process_id` of
    `process_count` (default: this process in its group): blocks of
    ceil(npix / count).  Pure index math, as in grtrans_tpu."""
    if process_id is None:
        process_id = dist.get_rank() if dist.is_initialized() else 0
    if process_count is None:
        process_count = dist.get_world_size() if dist.is_initialized() else 1
    per = -(-npix // process_count)
    lo = min(process_id * per, npix)
    return lo, min(lo + per, npix)


def snapshot_shard_spec(mesh, ndim, axis=2):
    """The placement of a snapshot grid of `ndim` axes sharded over its
    theta axis (axis 2 of Grmhd3D.stacked_grid's (nt, nx1, nx2, nx3, 2 nf)):
    [Shard(axis)] over the 1-D mesh, for
    torch.distributed.tensor.distribute_tensor.  Rays cluster in theta by
    camera row, so most trilinear lookups stay on their slab, and the halo
    is one row deep.  With src_data_rank=None every process cuts its own
    slab from its own copy of the grid, with no communication."""
    _check_mesh(mesh)
    if not -ndim <= axis < ndim:
        raise ValueError(f"axis {axis} of a {ndim}-axis grid")
    return [Shard(axis % ndim)]


def halo_exchange_theta(grid, mesh, axis=0):
    """The one-row halo of a theta slab (`axis` of this process's block):
    (lo_ghost, hi_ghost), the last row of the previous process's block and
    the first of the next's, by one batch_isend_irecv between neighbours.
    The first and the last process take their own boundary row, as in
    grtrans_tpu."""
    group = _check_mesh(mesh)
    n, i = mesh.size(), mesh.get_local_rank()
    first = grid.select(axis, 0).contiguous()
    last = grid.select(axis, grid.shape[axis] - 1).contiguous()
    lo, hi = first, last
    ops = []
    if i + 1 < n:
        hi = torch.empty_like(last)
        peer = dist.get_global_rank(group, i + 1)
        ops += [dist.P2POp(dist.isend, last, peer, group),
                dist.P2POp(dist.irecv, hi, peer, group)]
    if i > 0:
        lo = torch.empty_like(first)
        peer = dist.get_global_rank(group, i - 1)
        ops += [dist.P2POp(dist.isend, first, peer, group),
                dist.P2POp(dist.irecv, lo, peer, group)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return lo, hi


def pixel_block(mesh, npix):
    """This process's [lo, hi) block of `npix` pixels under the mesh: the
    block jax.device_put gives a device with NamedSharding(P("pix")), which
    refuses a pixel count the mesh size does not divide; so does this."""
    _check_mesh(mesh)
    n = mesh.size()
    if npix % n:
        raise ValueError(f"{npix} pixels over a mesh of {n}: the pixel "
                         f"count must be divisible by {n}")
    per = npix // n
    lo = mesh.get_local_rank() * per
    return lo, lo + per


def shard_pixels(mesh, *arrays):
    """Each array's block of its leading (pixel) axis on this process
    (views), as NamedSharding(P("pix")) places it."""
    blocks = [pixel_block(mesh, x.shape[0]) for x in arrays]
    return tuple(x[lo:hi] for x, (lo, hi) in zip(arrays, blocks))


def gather_pixels(mesh, block, dim=0):
    """The whole tensor, on every process, from each process's block along
    the pixel axis `dim` (one all_gather_into_tensor); blocks are equal in
    size."""
    group = _check_mesh(mesh)
    moved = block.movedim(dim, 0).contiguous()
    out = moved.new_empty((mesh.size() * moved.shape[0],) + moved.shape[1:])
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def all_reduce(mesh, x, op=dist.ReduceOp.SUM):
    """x reduced over the mesh (a new tensor; x is left as it is)."""
    out = x.clone()
    dist.all_reduce(out, op=op, group=_check_mesh(mesh))
    return out


def render_sharded(render_fn, mesh, cam_arrays, *args, **kwargs):
    """render_fn(*this process's blocks of cam_arrays, *args, **kwargs),
    gathered: render_fn must be pixel-elementwise over the leading axis of
    its camera arrays and of its result.  Returns the whole result on every
    process."""
    return gather_pixels(mesh, render_fn(*shard_pixels(mesh, *cam_arrays),
                                         *args, **kwargs))


def mesh_device(mesh):
    """This process's device of the mesh: the CPU, or the card that
    init_distributed made current."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def check_device(mesh, device):
    """Raise unless `device` is this process's device of the mesh and the
    mesh's group runs the backend of its device type (NCCL on "cuda").
    Raises before any collective, so that a refused call does not leave
    the other processes waiting in one."""
    group = _check_mesh(mesh)
    want = BACKENDS.get(mesh.device_type)
    have = dist.get_backend(group)
    if have != want:
        raise ValueError(f"a {mesh.device_type} mesh runs {want}, not "
                         f"{have}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev != mesh_device(mesh):
        raise ValueError(f"device {dev} is not this process's device of "
                         f"the mesh, {mesh_device(mesh)}")


def _check_mesh(mesh):
    """The process group of a 1-D mesh that holds this process."""
    if not isinstance(mesh, DeviceMesh) or mesh.ndim != 1:
        raise TypeError(f"expected a 1-D DeviceMesh, got {mesh!r}")
    if mesh.get_coordinate() is None:
        raise ValueError("this process is not in the mesh")
    return mesh.get_group(0)
