"""Carlson symmetric elliptic integrals and the Legendre forms built on
them, elementwise over broadcast float64 tensors.

Port of grtrans_tpu/ops/elliptic.py (reference geokerr_wrapper.f:3444 RF,
:3608 RC, :3648 RD, :3697 RJ): a fixed count of duplication steps in
place of the reference's convergence loops (each step shrinks the error
scale by 4; N_ITER = 26 with the 5th-order Taylor tail reaches float64
roundoff for every physical argument).  No render path calls these; they
are the layer-callable library of the reference.

Arguments are tensors, or Python numbers that broadcast against them;
the result lies on the tensors' device.
"""

import torch

N_ITER = 26


def _f64(*xs):
    """The arguments as broadcast float64 tensors on the device of the
    tensor among them."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    if dev is None:
        raise TypeError("pass at least one argument as a tensor: it names "
                        "the device")
    return torch.broadcast_tensors(*(torch.as_tensor(x, dtype=torch.float64,
                                                     device=dev) for x in xs))


def rf(x, y, z):
    """Carlson R_F(x, y, z); x, y, z >= 0 with at most one zero."""
    x, y, z = _f64(x, y, z)
    for _ in range(N_ITER):
        sx, sy, sz = x.sqrt(), y.sqrt(), z.sqrt()
        lam = sx * sy + sy * sz + sz * sx
        x, y, z = 0.25 * (x + lam), 0.25 * (y + lam), 0.25 * (z + lam)
    av = (x + y + z) / 3.0
    dx = (av - x) / av
    dy = (av - y) / av
    dz = (av - z) / av
    e2 = dx * dy + dy * dz + dz * dx
    e3 = dx * dy * dz
    s = 1.0 - e2 / 10.0 + e3 / 14.0 + e2 * e2 / 24.0 - 3.0 * e2 * e3 / 44.0
    return s / av.sqrt()


def rc(x, y):
    """Carlson R_C(x, y) = R_F(x, y, y); x >= 0, y != 0 (the Cauchy
    principal value for y < 0)."""
    x, y = _f64(x, y)
    # y < 0: R_C(x, y) = sqrt(x / (x - y)) R_C(x - y, -y)
    neg = y < 0.0
    xs = torch.where(neg, x - y, x)
    ys = torch.where(neg, -y, y)
    w = torch.where(neg, (x / torch.where(neg, x - y, 1.0)).sqrt(), 1.0)
    for _ in range(N_ITER):
        lam = 2.0 * xs.sqrt() * ys.sqrt() + ys
        xs, ys = 0.25 * (xs + lam), 0.25 * (ys + lam)
    av = (xs + ys + ys) / 3.0
    s = (ys - av) / av
    p = s * s * (0.3 + s * (1.0 / 7.0 + s * (0.375 + s * 9.0 / 22.0)))
    return w * (1.0 + p) / av.sqrt()


def rd(x, y, z):
    """Carlson R_D(x, y, z) = R_J(x, y, z, z); x, y >= 0 (at most one
    zero), z > 0."""
    x, y, z = _f64(x, y, z)
    acc = torch.zeros_like(x)
    fac = torch.ones_like(x)
    for _ in range(N_ITER):
        sx, sy, sz = x.sqrt(), y.sqrt(), z.sqrt()
        lam = sx * sy + sy * sz + sz * sx
        acc = acc + fac / (sz * (z + lam))
        fac = 0.25 * fac
        x, y, z = 0.25 * (x + lam), 0.25 * (y + lam), 0.25 * (z + lam)
    av = (x + y + 3.0 * z) / 5.0
    dx = (av - x) / av
    dy = (av - y) / av
    dz = (av - z) / av
    ea = dx * dy
    eb = dz * dz
    ec = ea - eb
    ed = ea - 6.0 * eb
    ee = ed + ec + ec
    s = ed * (-3.0 / 14.0 + 9.0 / 88.0 * ed - 4.5 / 26.0 * dz * ee) \
        + dz * (1.0 / 6.0 * ee + dz * (-9.0 / 22.0 * ec
                                       + dz * 3.0 / 26.0 * ea))
    return 3.0 * acc + fac * (1.0 + s) / (av * av.sqrt())


def rj(x, y, z, p):
    """Carlson R_J(x, y, z, p); x, y, z >= 0 (at most one zero), p > 0."""
    x, y, z, p = _f64(x, y, z, p)
    acc = torch.zeros_like(x)
    fac = torch.ones_like(x)
    for _ in range(N_ITER):
        sx, sy, sz = x.sqrt(), y.sqrt(), z.sqrt()
        lam = sx * sy + sy * sz + sz * sx
        alpha = (p * (sx + sy + sz) + sx * sy * sz) ** 2
        beta = p * (p + lam) ** 2
        acc = acc + fac * rc(alpha, beta)
        fac = 0.25 * fac
        x, y, z, p = (0.25 * (x + lam), 0.25 * (y + lam), 0.25 * (z + lam),
                      0.25 * (p + lam))
    av = (x + y + z + 2.0 * p) / 5.0
    dx = (av - x) / av
    dy = (av - y) / av
    dz = (av - z) / av
    dp = (av - p) / av
    ea = dx * (dy + dz) + dy * dz
    eb = dx * dy * dz
    ec = dp * dp
    ed = ea - 3.0 * ec
    ee = eb + 2.0 * dp * (ea - ec)
    s = ed * (-3.0 / 14.0 + 9.0 / 88.0 * ed - 4.5 / 26.0 * ee) \
        + eb * (1.0 / 6.0 + dp * (-3.0 / 11.0 + dp * 3.0 / 26.0)) \
        + dp * ea * (1.0 / 3.0 - dp * 3.0 / 22.0) - dp * ec / 3.0
    return 3.0 * acc + fac * (1.0 + s) / (av * av.sqrt())


def ellf(phi, m):
    """Incomplete elliptic integral of the first kind F(phi | m) =
    sin(phi) R_F(cos^2 phi, 1 - m sin^2 phi, 1), for |phi| <= pi/2 and any
    m with 1 - m sin^2 phi > 0 (m < 0 too)."""
    phi, m = _f64(phi, m)
    s, c = phi.sin(), phi.cos()
    return s * rf(c * c, 1.0 - m * s * s, 1.0)


def ellk(m):
    """Complete elliptic integral K(m), parameter m = k^2 (may be < 0)."""
    (m,) = _f64(m)
    return rf(torch.zeros_like(m), 1.0 - m, 1.0)


def elle(phi, m):
    """Incomplete elliptic integral of the second kind E(phi | m)."""
    phi, m = _f64(phi, m)
    s, c = phi.sin(), phi.cos()
    q = 1.0 - m * s * s
    return s * rf(c * c, q, 1.0) - (m / 3.0) * s ** 3 * rd(c * c, q, 1.0)
