"""Weierstrass elliptic functions and the Biermann-Weierstrass quartic
inversion.  Port of grtrans_tpu/ops/weierstrass.py: the same Laurent
series (K_SERIES terms) evaluated at z/2^n and n <= MAX_DOUBLINGS
duplication steps, masked per element."""

import torch

from grtrans_tpu_torch.ops.intcast import to_int32

K_SERIES = 16
MAX_DOUBLINGS = 20


def quartic_invariants(A, B, C, D, E):
    """Weierstrass invariants (g2, g3) of f(x)=A x^4 + B x^3 + C x^2 + D x + E
    (binomial normalization a0=A, a1=B/4, a2=C/6, a3=D/4, a4=E)."""
    a0, a1, a2, a3, a4 = A, B / 4.0, C / 6.0, D / 4.0, E
    g2 = a0 * a4 - 4.0 * a1 * a3 + 3.0 * a2 * a2
    g3 = (a0 * a2 * a4 + 2.0 * a1 * a2 * a3 - a2 ** 3
          - a0 * a3 * a3 - a1 * a1 * a4)
    return g2, g3


def _series_coeffs(g2, g3):
    """Laurent coefficients c_k of wp(z) = z^-2 + sum_k c_k z^(2k-2)."""
    cs = [None, None, g2 / 20.0, g3 / 28.0]
    for k in range(4, K_SERIES + 2):
        acc = cs[2] * cs[k - 2]
        for mm in range(3, k - 1):
            acc = acc + cs[mm] * cs[k - mm]
        cs.append(3.0 / ((2 * k + 1) * (k - 3)) * acc)
    return cs[2:]


def wp(z, g2, g3):
    """Weierstrass (wp(z), wp'(z)) for real z > 0 and real invariants
    (tensors that broadcast).  Per element, n doublings bring z/2^n into
    the series region; the duplication map then runs n times.  The loop
    stops after the largest n in the batch, which is the same as running
    all MAX_DOUBLINGS masked steps."""
    if z.dim() < g2.dim() or z.dim() < g3.dim():
        z = z.expand(torch.broadcast_shapes(z.shape, g2.shape, g3.shape))
    t = torch.maximum(g2.abs() ** 0.25, g3.abs() ** (1.0 / 6.0))
    target = 0.25 / t.clamp_min(1e-37)
    n = torch.ceil(torch.log2((z.abs() / target).clamp_min(1.0)))
    n = to_int32(n.clamp(0, MAX_DOUBLINGS))
    zs = z / torch.exp2(n.to(z.dtype))

    cs = _series_coeffs(g2, g3)
    z2 = zs * zs
    # wp = 1/z^2 + sum c_k z^(2k-2);  wp' = -2/z^3 + sum (2k-2) c_k z^(2k-3)
    p_ser = torch.zeros_like(zs)
    dp_ser = torch.zeros_like(zs)
    for i in range(len(cs) - 1, -1, -1):
        k = i + 2
        p_ser = p_ser * z2 + cs[i]
        dp_ser = dp_ser * z2 + (2 * k - 2) * cs[i]
    p = 1.0 / z2 + z2 * p_ser
    dp = -2.0 / (z2 * zs) + zs * dp_ser

    for i in range(int(n.max()) if n.numel() else 0):
        ddp = 6.0 * p * p - 0.5 * g2          # wp''
        dddp = 12.0 * p * dp                  # wp'''
        safe = torch.where(dp.abs() > 1e-37, dp, 1e-37)
        h = ddp / (2.0 * safe)
        hp = (dp * dddp - ddp * ddp) / (2.0 * safe * safe)
        doit = i < n
        p, dp = (torch.where(doit, h * h - 2.0 * p, p),
                 torch.where(doit, h * hp - dp, dp))
    return p, dp


def quartic_coeff_derivs(A, B, C, D, E, x0):
    """f(x0), f'(x0), f''(x0), f'''(x0), f'''' for the BW formula."""
    f0 = (((A * x0 + B) * x0 + C) * x0 + D) * x0 + E
    f1 = ((4.0 * A * x0 + 3.0 * B) * x0 + 2.0 * C) * x0 + D
    f2 = (12.0 * A * x0 + 6.0 * B) * x0 + 2.0 * C
    f3 = 24.0 * A * x0 + 6.0 * B
    f4 = 24.0 * A
    return f0, f1, f2, f3, f4


def _bw_terms(A, B, C, D, E, x0, s, lam, g2, g3):
    if g2 is None:
        g2, g3 = quartic_invariants(A, B, C, D, E)
    f0, f1, f2, f3, f4 = quartic_coeff_derivs(A, B, C, D, E, x0)
    # lam = 0 sits on wp's pole; the result there is x0 (selected below)
    zero = lam == 0.0
    p, dp = wp(torch.where(zero, 1e-8, lam), g2, g3)
    sq = f0.clamp_min(0.0).sqrt()
    pm = p - f2 / 24.0
    num = -s * sq * dp + 0.5 * f1 * pm + f0 * f3 / 24.0
    den = 2.0 * pm * pm - f0 * f4 / 48.0
    return zero, p, dp, sq, pm, num, den, g2, f1


def invert_quartic(A, B, C, D, E, x0, s, lam, g2=None, g3=None):
    """Biermann-Weierstrass inversion: x(lam) of dx/dlam = +-sqrt(f(x)),
    x(0) = x0, dx/dlam(0) = s sqrt(f(x0)).  Turning points are traversed
    by the formula itself."""
    zero, _, _, _, _, num, den, _, _ = _bw_terms(A, B, C, D, E, x0, s, lam,
                                                 g2, g3)
    x = x0 + num / den
    return torch.where(zero, x0, x)


def invert_quartic_with_deriv(A, B, C, D, E, x0, s, lam, g2=None, g3=None):
    """invert_quartic plus the signed dx/dlam, from the chain rule with
    wp'' = 6 wp^2 - g2/2."""
    zero, p, dp, sq, pm, num, den, g2, f1 = _bw_terms(A, B, C, D, E, x0, s,
                                                      lam, g2, g3)
    ddp = 6.0 * p * p - 0.5 * g2
    x = x0 + num / den
    dnum = -s * sq * ddp + 0.5 * f1 * dp
    dden = 4.0 * pm * dp
    dx = (dnum * den - num * dden) / (den * den)
    return torch.where(zero, x0, x), torch.where(zero, s * sq, dx)
