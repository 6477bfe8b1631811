"""Batched quartic roots by Durand-Kerner, carried as explicit (re, im)
float64 pairs.  Port of grtrans_tpu/ops/polyroots.py: same start points,
24 iterations, one Newton polish, degenerate-degree branches and the sort
by real part (the turning-point landmarks depend on that order)."""

import torch

from grtrans_tpu_torch import obs

N_ITER = 24
BIG = 1e30


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(ar, ai, br, bi):
    d = br * br + bi * bi
    d = torch.where(d == 0.0, 1e-37, d)
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def _dk(coeffs, nroots):
    """Durand-Kerner on the monic z^n + sum coeffs[k] z^k.  Returns
    (re, im), each (..., n)."""
    n = nroots
    r = coeffs[0].abs().clamp_min(1.0)
    for c in coeffs[1:]:
        r = torch.maximum(r, c.abs())
    r = 1.0 + r
    like = dict(dtype=r.dtype, device=r.device)
    with obs.sync("polyroots._dk", 2):
        base_re = torch.tensor([0.4, -0.65, -0.908, -0.0959][:n], **like)
        base_im = torch.tensor([0.9, 0.72, -0.297, -0.936][:n], **like)
    zr = r[..., None] * base_re
    zi = r[..., None] * base_im
    cs = [c[..., None] for c in coeffs]
    eye = torch.eye(n, **like)

    def poly(zr, zi):
        pr = torch.ones_like(zr)
        pi = torch.zeros_like(zr)
        for c in reversed(cs):
            pr, pi = _cmul(pr, pi, zr, zi)
            pr = pr + c
        return pr, pi

    for _ in range(N_ITER):
        dr = zr[..., :, None] - zr[..., None, :] + eye
        di = zi[..., :, None] - zi[..., None, :]
        prodr = torch.ones_like(zr)
        prodi = torch.zeros_like(zr)
        for j in range(n):
            prodr, prodi = _cmul(prodr, prodi, dr[..., j], di[..., j])
        pr, pi = poly(zr, zi)
        sr, si = _cdiv(pr, pi, prodr, prodi)
        zr, zi = zr - sr, zi - si

    # one Newton polish
    dpr = torch.full_like(zr, float(n))
    dpi = torch.zeros_like(zr)
    for k in range(n - 1, 0, -1):
        dpr, dpi = _cmul(dpr, dpi, zr, zi)
        dpr = dpr + k * cs[k]
    pr, pi = poly(zr, zi)
    sr, si = _cdiv(pr, pi, dpr, dpi)
    return zr - sr, zi - si


def quartic_roots(c0, c1, c2, c3, c4):
    """All roots of c4 x^4 + c3 x^3 + c2 x^2 + c1 x + c0, degree-robust.

    Arguments are float64 tensors (or numbers, if at least one is a
    tensor) that broadcast; returns (re, im) with trailing axis 4 sorted
    by real part.  Missing roots of a degenerate polynomial are BIG."""
    dev = next(c.device for c in (c0, c1, c2, c3, c4) if torch.is_tensor(c))
    c0, c1, c2, c3, c4 = torch.broadcast_tensors(
        *[torch.as_tensor(c, dtype=torch.float64, device=dev)
          for c in (c0, c1, c2, c3, c4)])
    S = c0.abs()
    for c in (c1, c2, c3, c4):
        S = torch.maximum(S, c.abs())
    S = S.clamp_min(1e-37)
    tol = 1e-13
    is4 = c4.abs() > tol * S
    is3 = c3.abs() > tol * S
    is2 = c2.abs() > tol * S

    safe4 = torch.where(is4, c4, 1.0)
    safe3 = torch.where(is3, c3, 1.0)
    safe2 = torch.where(is2, c2, 1.0)
    safe1 = torch.where(c1.abs() > 0, c1, 1.0)

    q4r, q4i = _dk([c0 / safe4, c1 / safe4, c2 / safe4, c3 / safe4], 4)

    c3r, c3i = _dk([c0 / safe3, c1 / safe3, c2 / safe3], 3)
    big = torch.full_like(c0, BIG)
    zero = torch.zeros_like(c0)
    q3r = torch.cat([c3r, big[..., None]], dim=-1)
    q3i = torch.cat([c3i, zero[..., None]], dim=-1)

    # quadratic closed form
    b0, b1 = c0 / safe2, c1 / safe2
    disc = b1 * b1 - 4.0 * b0
    sq = disc.abs().sqrt()
    real = disc >= 0
    rr1 = torch.where(real, 0.5 * (-b1 - sq), -0.5 * b1)
    rr2 = torch.where(real, 0.5 * (-b1 + sq), -0.5 * b1)
    ri1 = torch.where(real, 0.0, -0.5 * sq)
    ri2 = torch.where(real, 0.0, 0.5 * sq)
    q2r = torch.stack([rr1, rr2, big, big], dim=-1)
    q2i = torch.stack([ri1, ri2, zero, zero], dim=-1)

    # linear
    lroot = -c0 / safe1
    q1r = torch.stack([lroot, big, big, big], dim=-1)
    q1i = torch.zeros_like(q1r)

    sel4, sel3, sel2 = is4[..., None], is3[..., None], is2[..., None]
    zr = torch.where(sel4, q4r, torch.where(sel3, q3r,
                                            torch.where(sel2, q2r, q1r)))
    zi = torch.where(sel4, q4i, torch.where(sel3, q3i,
                                            torch.where(sel2, q2i, q1i)))

    order = torch.argsort(zr, dim=-1, stable=True)
    return zr.gather(-1, order), zi.gather(-1, order)


def real_roots_mask(roots_re, roots_im, rel_tol=1e-8):
    """Mask of which roots are (numerically) real and finite."""
    scale = roots_re.abs().clamp_min(1.0)
    return ((roots_im.abs() <= rel_tol * scale)
            & (roots_re.abs() < BIG / 10))
