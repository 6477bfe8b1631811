"""Parity of the port's camera and geodesic trace with grtrans_tpu at the
flagship camera (spin 0.998, mu0 0.906, uout 0.01), 16x16 pixels x 64
points, float64.

Tolerances.  The camera is exact.  The trace is compared elementwise over
valid samples, |d| / |ref|.  The bar of 1e-10 cannot hold everywhere:
the turning-point landmarks (lam_rturn, lam_t1) are ill-conditioned
integrals (~1e-12 from last-bit changes of the roots), and the wp
argument doublings multiply that ~4x per step.  grtrans_tpu jitted and
grtrans_tpu run eagerly differ by as much as the port and grtrans_tpu do
(max / p99.9 for x 7.3e-7 / 7.1e-9, k 2.5e-4 / 7.1e-8, lam 4.6e-10 /
9.5e-11, mino 4.9e-13), so the bars below sit ~3x above that spread.

trace_polar (thin-disk camera, spin 0.9, mu0 0.26; npts 1 and 8, crossing
1 and 2) and camera_delay take the exact-node branch of the cumulative
phases: every quadrature node is a Weierstrass inversion, no Hermite fill.
Bar 1e-10 elementwise over valid samples for x, lam, mino and the delay
(measured: x 2.1e-11, lam 1.8e-12, mino 6.5e-16, delay 3.8e-16).  k is
held to 1e-7 (measured 1.7e-8): k^r and k^theta are square roots of
potentials that vanish at turning points, which doubles the digits lost
in u and mu there.
"""

import jax
import numpy as np
import pytest
import torch

from grtrans_tpu.geodesics import camera as jcam
from grtrans_tpu.geodesics import geokerr as jgeo
from grtrans_tpu_torch.geodesics import camera as tcam
from grtrans_tpu_torch.geodesics import geokerr as tgeo

torch.set_num_threads(1)   # the suite runs in parallel worker processes

A, MU0 = 0.998, 0.906
GRID = (-40.0, 20.0, -20.0, 40.0)
N, NPTS = 16, 64
# field: (max elementwise rel, p99.9 elementwise rel)
BARS = {"x": (2e-6, 2e-8), "k": (1e-3, 2e-7), "lam": (1.5e-9, 3e-10),
        "mino": (1.5e-12, 1.5e-12)}


@pytest.fixture(scope="module")
def traces():
    cj = jcam.make_camera(A, MU0, *GRID, N, N)
    ct = tcam.make_camera(A, MU0, *GRID, N, N, device="cpu")
    gj = jgeo.trace(A, MU0, cj.alpha, cj.beta, cj.l, cj.q2, cj.sm, cj.u0,
                    NPTS, uout=0.01, phi0=-0.5)
    gt = tgeo.trace(A, MU0, ct.alpha, ct.beta, ct.l, ct.q2, ct.sm, ct.u0,
                    NPTS, uout=0.01, phi0=-0.5)
    return cj, ct, jax.tree_util.tree_map(np.asarray, gj), gt


def test_make_camera(traces):
    cj, ct, _, _ = traces
    for f in ("alpha", "beta", "l", "q2", "sm", "su"):
        np.testing.assert_array_equal(getattr(ct, f).numpy(),
                                      np.asarray(getattr(cj, f)))
    assert (ct.u0, ct.mu0, ct.a) == (cj.u0, cj.mu0, cj.a)
    assert ct.alpha.dtype == torch.float64


@pytest.mark.parametrize("field", sorted(BARS))
def test_trace_values(traces, field):
    _, _, gj, gt = traces
    ref = getattr(gj, field)[gj.valid]
    ours = getattr(gt, field).numpy()[gj.valid]
    rel = np.abs(ours - ref) / np.maximum(np.abs(ref), 1e-300)
    worst, p999 = rel.max(), np.quantile(rel, 0.999)
    print(f"{field}: max rel {worst:.3e}, p99.9 {p999:.3e}")
    assert worst <= BARS[field][0] and p999 <= BARS[field][1]


def test_trace_landmarks(traces):
    _, _, gj, gt = traces
    for f in ("tpm", "tpr", "valid", "status"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(), getattr(gj, f))
    assert gj.valid.mean() > 0.5


PA, PMU0 = 0.9, 0.26
PGRID = (-21.0, 21.0, -21.0, 21.0)
# field: max elementwise rel over valid samples
TRACE_POLAR_BARS = {"x": 1e-10, "lam": 1e-10, "mino": 1e-10, "k": 1e-7}


@pytest.fixture(scope="module")
def disk_cameras():
    return (jcam.make_camera(PA, PMU0, *PGRID, N, N),
            tcam.make_camera(PA, PMU0, *PGRID, N, N, device="cpu"))


@pytest.mark.parametrize("crossing", [1, 2])
@pytest.mark.parametrize("npts", [1, 8])
def test_trace_polar(disk_cameras, npts, crossing):
    cj, ct = disk_cameras
    gj = jgeo.trace_polar(PA, PMU0, cj.alpha, cj.beta, cj.l, cj.q2, cj.sm,
                          cj.u0, npts=npts, phi0=-0.5, crossing=crossing)
    gj = jax.tree_util.tree_map(np.asarray, gj)
    gt = tgeo.trace_polar(PA, PMU0, ct.alpha, ct.beta, ct.l, ct.q2, ct.sm,
                          ct.u0, npts=npts, phi0=-0.5, crossing=crossing)
    assert gt.x.shape == (N * N, npts, 4)
    for f in ("tpm", "tpr", "valid", "status"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(), getattr(gj, f))
    hit = gj.status == 1
    assert 0.1 < hit.mean() < 1.0           # some rays miss the disk
    # exactly the equator at the last point of every ray that hits
    assert (gt.x[..., -1, 2].numpy()[hit] == np.arccos(0.0)).all()
    for field, bar in TRACE_POLAR_BARS.items():
        ref = getattr(gj, field)[gj.valid]
        ours = getattr(gt, field).numpy()[gj.valid]
        scale = np.abs(ref)
        if field in ("x", "k"):
            # components that pass through zero (t at the start, k^theta
            # at a turn) are held to the bar of the vector's size
            scale = np.maximum(scale, np.abs(ref).max(-1, keepdims=True))
        rel = (np.abs(ours - ref) / np.maximum(scale, 1e-300)).max()
        print(f"npts={npts} crossing={crossing} {field}: max rel {rel:.3e}")
        assert rel <= bar, field


def test_camera_delay(disk_cameras):
    cj, ct = disk_cameras
    ref = np.asarray(jgeo.camera_delay(PA, PMU0, cj.alpha, cj.beta, cj.l,
                                       cj.q2, cj.sm, cj.u0, 0.01))
    ours = tgeo.camera_delay(PA, PMU0, ct.alpha, ct.beta, ct.l, ct.q2, ct.sm,
                             ct.u0, 0.01).numpy()
    assert ours.shape == (N * N,) and np.isfinite(ref).all()
    rel = (np.abs(ours - ref) / np.abs(ref)).max()
    print(f"camera_delay: max rel {rel:.3e}")
    assert rel <= 1e-10
    # light takes about r_camera - 100 M (plus a logarithm) to reach r = 100
    np.testing.assert_allclose(ours, 1.0 / ct.u0 - 100.0, rtol=1e-5)
