"""Modified Bessel functions via the Abramowitz & Stegun 9.8.x polynomial
fits (reference bessel.f90:18-132), used by the thermal synchrotron and
Faraday coefficients: elementwise, both branches evaluated and selected
with torch.where, arguments floored so the unused branch stays finite."""

import torch


def besseli0(x):
    x = x.abs()
    t = (x / 3.75) ** 2
    small = (((((0.0045813 * t + 0.0360768) * t + 0.2659732) * t
               + 1.2067492) * t + 3.0899424) * t + 3.5156229) * t + 1.0
    xs = x.clamp_min(1e-37)
    ti = 3.75 / xs
    big = (torch.exp(x) / xs.sqrt()) * (
        0.39894228 + ti * (0.01328592 + ti * (0.00225319 + ti * (
            -0.00157565 + ti * (0.00916281 + ti * (-0.02057706 + ti * (
                0.02635537 + ti * (-0.01647633 + ti * 0.00392377))))))))
    return torch.where(x < 3.75, small, big)


def besseli1(x):
    ax = x.abs()
    t = (ax / 3.75) ** 2
    small = ax * ((((((0.00032411 * t + 0.00301532) * t + 0.02658733) * t
                     + 0.15084934) * t + 0.51498869) * t + 0.87890594) * t
                  + 0.5)
    xs = ax.clamp_min(1e-37)
    ti = 3.75 / xs
    big = (torch.exp(ax) / xs.sqrt()) * (
        0.39894228 + ti * (-0.03988024 + ti * (-0.00362018 + ti * (
            0.00163801 + ti * (-0.01031555 + ti * (0.02282967 + ti * (
                -0.02895312 + ti * (0.01787654 + ti * (-0.00420059)))))))))
    return torch.sign(x) * torch.where(ax < 3.75, small, big)


def besselk0(x):
    x = x.clamp_min(1e-37)
    t = (x / 2.0) ** 2
    small = -torch.log(x / 2.0) * besseli0(x) + (
        -0.57721566 + t * (0.42278420 + t * (0.23069756 + t * (
            0.03488590 + t * (0.00262698 + t * (0.00010750
                                                + t * 0.0000074))))))
    ti = 2.0 / x
    big = (torch.exp(-x) / x.sqrt()) * (
        1.25331414 + ti * (-0.07832358 + ti * (0.02189568 + ti * (
            -0.01062446 + ti * (0.00587872 + ti * (-0.00251540
                                                   + ti * 0.00053208))))))
    return torch.where(x <= 2.0, small, big)


def besselk1(x):
    x = x.clamp_min(1e-37)
    t = (x / 2.0) ** 2
    small = torch.log(x / 2.0) * besseli1(x) + (1.0 / x) * (
        1.0 + t * (0.15443144 + t * (-0.67278579 + t * (
            -0.18156897 + t * (-0.01919402 + t * (-0.00110404
                                                  + t * (-0.00004686)))))))
    ti = 2.0 / x
    big = (torch.exp(-x) / x.sqrt()) * (
        1.25331414 + ti * (0.23498619 + ti * (-0.03655620 + ti * (
            0.01504268 + ti * (-0.00780353 + ti * (0.00325614
                                                   + ti * (-0.00068245)))))))
    return torch.where(x <= 2.0, small, big)


def besselk2(x):
    """K_2 by the recurrence K_{n+1} = K_{n-1} + (2n/x) K_n (reference
    bessel.f90 bessk)."""
    return besselk0(x) + (2.0 / x.clamp_min(1e-37)) * besselk1(x)


