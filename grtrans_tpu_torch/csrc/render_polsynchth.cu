// The thermal-synchrotron coefficients of a ray-integrating render in one
// launch a frequency, for Hopper (sm_90a), in float64 and float32.
//
//   (j, K, ok)[p, i] = the comoving tetrad, POLSYNCHTH's 11 coefficients,
//                      their rotation and invariant scaling at sample i of
//                      pixel p
//
// Replaces no Pallas kernel: it stands for XLA's fusion of
// grtrans_tpu/driver.py:render_rays (:149, from the fluid to
// solvers.observed_stokes), grtrans_tpu/geometry/tetrad.py:comoving_ortho
// (:52) and grtrans_tpu/emis/polsynch.py:polsynchth (:75), which XLA fuses
// into a few loops over the samples.  Its plain PyTorch twin is the torch
// code of grtrans_tpu_torch/driver.py:render_rays (tetrad.comoving_ortho,
// polsynch.polsynchth, framework.rotate_emis and invariant_emis), which on
// the card ran as ~1,600 elementwise launches a render, each a pass over
// device memory for one or two operations.  One thread a sample does, in
// registers, what those launches do between the fluid and the march:
//  * the sanitising of u and b (okf: every component finite), the
//    covariant Boyer-Lindquist metric (kerr.metric_cov, Delta factored),
//    the Walker-Penrose transport of the polarization basis
//    (transport_perpk, the pole-on kappa1 = kappa2 = 0 basis along e_phi),
//    the Kulkarni+2011 tetrad with its frame_ok, the projections of b, k
//    and the basis, sin / cos 2 xi, the pitch angle and the redshift g;
//  * render_rays' mask ok (geo.valid, okf, frame_ok, g, s2xi, c2xi and the
//    angle finite; under prec="mixed" also r - r+ > HOR_F32 r+) and g
//    clamped to [1e-8, 1e8];
//  * polsynchth at nu = f / g: bnu with its T = 0 floor and Rayleigh-Jeans
//    branch, the Shcherbakov fits' argument with its B = 0 branch, 1 /
//    theta_e clamped at 150, the Bessel fits of ops/bessel.py, the
//    theta_e > 1e-2 split and the tanh step;
//  * coefindx's multipliers of the 7 K columns, every coefficient that is
//    not finite (or of a sample not ok) set to 0, the rotation by 2 xi
//    (nvals = 4), j g^2, K / g and the scale lbh;
// and writes j (npix, npts, 4), K (npix, npts, 7) and ok (npix, npts) as
// observed_stokes takes them.  A sample that is not ok writes zeros, as
// the twin's masks leave it (+0 in every column), and stops at the first
// test it fails.
//
// The operations are the twin's, in its order and in the operands' type,
// so that each rounds as torch's separate kernels round it (built with
// -fmad=false, ops/render_polsynchth.py: no product and sum fused).
// Torch's arithmetic on the card, which the kernel follows: a Python float
// meets a tensor cast to T, and the products and quotients of Python
// floats that the twin forms before it meets a tensor arrive formed (the
// wrapper's kernel_params); a tensor divided by a Python float is
// multiplied by the float's reciprocal, formed in double and cast; a
// Python float divided by a tensor is the tensor's reciprocal times the
// float (Tensor.__rtruediv__); x ** 2 is x * x, x ** 3 is x * x * x; a
// clamp lets a NaN through.  Where a torch.where evaluates both sides, the
// kernel computes the side it selects, and only the Bessel functions that
// theta_e > 1e-2 uses.  What changes no value of an ok sample: the packed
// metric's four zero entries (tr, tth, rth, thph) and cosne (which
// POLSYNCHTH does not read) are left out; a term with a zero entry adds a
// zero to a sum, or a NaN where another factor is infinite, and such a
// sample is not ok in either version.
//
// Instantiations: float64 (the cells), and float32 for prec="mixed",
// whose operands the wrapper rounds to float as the twin's .float() does,
// with bnu's float32 form (nu / c first) and the horizon cut.
//
// What bounds it on this card: a sample reads r and theta (x), k, u, b (4
// each), n, B, T and valid, 137 bytes in float64 (x is read whole in its
// 32-byte rows: 153), and writes j, K and ok, 89 bytes: 242 bytes, 6.3 GB
// at 256^2 x 400, 1.9 ms at 3.35 TB/s.  Its arithmetic, counted from this
// source by the branch a sample takes (chip_smoke.py's RENDER_OPS, an add,
// multiply, compare or negation one each): on the cells' common branch
// (ok, theta_e >= 0.5, Rayleigh-Jeans, B > 0, rotated) 697 of those, 64
// divides, reciprocals and square roots, 17 transcendental functions and
// 5 pows; priced at ~10, ~25 and ~50 each (estimates of their software
// sequences on the FP64 pipe, not counts), 2,012 operations a sample,
// 5.3e10 a render, 3.1 ms at the card's 16.75e12 unfused FP64 operations
// a second.  FP64 throughput binds, bytes behind (chip_smoke.py phase 30
// weights the branches by the frame's samples on each).  The design: one
// thread a sample, 26.2M-way parallel at 256^2 x 400 (the march's one
// thread a pixel would run these transcendentals serially over 400 samples
// in a quarter of the threads the card holds); every intermediate in
// registers, no shared memory, no synchronisation; a warp's samples are
// neighbouring points of one ray, so its branches mostly agree; a sample
// that fails a test stops there.
// Measured on an H100 (700 W) on the harm3d-incl-256-f64 frame: 5.63 ms in
// float64 at 92 registers (no spill; 53 in float32), against 543 ms for
// the twin's launches on the same operands.
//
// C interface (ctypes): render_polsynchth_f64 / render_polsynchth_f32
// launch on the given stream and return cudaGetLastError().  Operands, all
// contiguous and of T but the bytes: x, k, u, b (npix, npts, 4); valid
// (npix, npts) bytes, 0 or 1; alpha, beta (npix); n, bfield, te (npix,
// npts); out j (npix, npts, 4), kout (npix, npts, 7), ok (npix, npts)
// bytes.  params points to the host array of kNumParams values of T that
// ops/render_polsynchth.py:kernel_params makes, in the order of struct
// Params; rotate (0 or 1) applies rotate_emis.  The float32 entry point
// also makes the mixed leg's horizon cut.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// The scalars of a render as the twin's torch operations receive them.
template <typename T>
struct Params {
  // metric_cov's _delta factors 1 +- sqrt(1 - a^2), a, a^2, -2 a, -a; the
  // Walker-Penrose kappa1's a sqrt(1 - mu0^2); arccos's clamp
  T a, aa, delta_p, delta_m, m2a, neg_a, kap_c, ang_lo, ang_hi;
  // prec="mixed": r+ and HOR_F32 r+
  T rh, hor;
  // the observed frequency, lbh and coefindx's multipliers of K
  T fghz, lbh, mult[7];
  // polsynchth and bnu: k, 1 / (m c^2), 3 e, 1 / (4 pi m c), e^2 / c /
  // sqrt(3) / 2, 4 e^2 / c / 3 / sqrt(3), h, 1 / c^2, 2 h, 1 / c, 2 h / c
  T k, inv_mc2, c3e, inv_4pimc, cpref, cjv, h, inv_c2, c2h, inv_c, c2hc;
  // the Faraday fits: 4 pi, e^2, 1 / m, e, 1 / (m c), sqrt(2), 2 pi,
  // ln 120, 2^(-1/3) / 3^(23/6) pi 1e4
  T c4pi, e2, inv_m, e, inv_mc, sqrt2, two_pi, log120, cj;
};
constexpr int kNumParams = sizeof(Params<double>) / sizeof(double);
static_assert(sizeof(Params<float>) == kNumParams * sizeof(float),
              "Params holds only scalars of T");

// torch's clamp_min / clamp_max: a NaN goes through
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) {
  return isnan(v) ? v : (v < lo ? lo : v);
}
template <typename T>
__device__ __forceinline__ T clamp_max(T v, T hi) {
  return isnan(v) ? v : (v > hi ? hi : v);
}

// torch's reciprocal, for a Python float divided by a tensor
template <typename T>
__device__ __forceinline__ T recip(T x) {
  return T(1) / x;
}

// fourvector.dot over the packed metric's nonzero entries (tt, tph, rr,
// thth, phph), in _PAIRS' order: sum of g u v
template <typename T>
struct Metric {
  T tt, tph, rr, thth, phph;
};

template <typename T>
__device__ __forceinline__ T dot(const Metric<T>& g, const T* u,
                                 const T* v) {
  T out = T(0) + g.tt * u[0] * v[0];
  out = out + g.tph * (u[0] * v[3] + u[3] * v[0]);
  out = out + g.rr * u[1] * v[1];
  out = out + g.thth * u[2] * v[2];
  out = out + g.phph * u[3] * v[3];
  return out;
}

// ops/bessel.py's K0 and K1 (Abramowitz & Stegun 9.8.5-9.8.8) at x > 0,
// each the branch its torch.where selects (I0, I1 only below 2)
template <typename T>
__device__ __forceinline__ T besselk0(T x) {
  x = clamp_min(x, T(1e-37));
  if (x <= T(2)) {
    const T hx = x * T(0.5);
    const T t = hx * hx;
    const T z = x * T(1.0 / 3.75);
    const T ti = z * z;
    const T i0 =
        (((((T(0.0045813) * ti + T(0.0360768)) * ti + T(0.2659732)) * ti +
           T(1.2067492)) * ti + T(3.0899424)) * ti + T(3.5156229)) * ti +
        T(1);
    const T poly =
        t * (t * (t * (t * (t * (t * T(0.0000074) + T(0.00010750)) +
                            T(0.00262698)) + T(0.03488590)) +
                  T(0.23069756)) + T(0.42278420)) + T(-0.57721566);
    return -::log(x * T(0.5)) * i0 + poly;
  }
  const T ti = recip(x) * T(2);
  const T poly =
      ti * (ti * (ti * (ti * (ti * (ti * T(0.00053208) + T(-0.00251540)) +
                              T(0.00587872)) + T(-0.01062446)) +
                  T(0.02189568)) + T(-0.07832358)) + T(1.25331414);
  return (::exp(-x) / ::sqrt(x)) * poly;
}

template <typename T>
__device__ __forceinline__ T besselk1(T x) {
  x = clamp_min(x, T(1e-37));
  if (x <= T(2)) {
    const T hx = x * T(0.5);
    const T t = hx * hx;
    const T z = x * T(1.0 / 3.75);
    const T ti = z * z;
    // besseli1's small branch times sign(x) = 1
    const T i1 =
        x * ((((((T(0.00032411) * ti + T(0.00301532)) * ti + T(0.02658733)) *
                    ti + T(0.15084934)) * ti + T(0.51498869)) * ti +
              T(0.87890594)) * ti + T(0.5));
    const T poly =
        t * (t * (t * (t * (t * (t * T(-0.00004686) + T(-0.00110404)) +
                            T(-0.01919402)) + T(-0.18156897)) +
                  T(-0.67278579)) + T(0.15443144)) + T(1);
    return ::log(x * T(0.5)) * i1 + recip(x) * poly;
  }
  const T ti = recip(x) * T(2);
  const T poly =
      ti * (ti * (ti * (ti * (ti * (ti * T(-0.00068245) + T(0.00325614)) +
                              T(-0.00780353)) + T(0.01504268)) +
                  T(-0.03655620)) + T(0.23498619)) + T(1.25331414);
  return (::exp(-x) / ::sqrt(x)) * poly;
}

// polsynch.bnu, the branch its torch.where selects
template <typename T>
__device__ __forceinline__ T bnu(T te, T nu, const Params<T>& p) {
  if (te == T(0)) return T(2.2e-16);
  const T x = (nu * p.h) / (te * p.k);
  T v;
  if (x < T(1e-6)) {
    if constexpr (sizeof(T) == 4) {
      const T nuc = nu * p.inv_c;
      v = nuc * T(2) * nuc * p.k * te;
    } else {
      v = nu * T(2) * nu * p.k * te * p.inv_c2;
    }
  } else {
    const T den = ::expm1(clamp_min(x, T(1e-6)));
    if constexpr (sizeof(T) == 4) {
      v = nu * p.inv_c * p.c2hc * nu * nu / den;
    } else {
      v = nu * nu * nu * p.c2h * p.inv_c2 / den;
    }
  }
  return clamp_min(v, T(2.2e-16));
}

// polsynch._jffunc and _shgmfunc
template <typename T>
__device__ __forceinline__ T jffunc(T x, const Params<T>& p) {
  const T e472 = ::exp(-x * T(1.0 / 47.2));
  const T step = ::tanh((::log(x + T(1e-37)) - p.log120) * T(1.0 / 0.1)) *
                     T(0.5) + T(0.5);
  const T extra =
      (e472 * T(0.011) - p.cj * ::pow(x + T(1e-16), T(-8.0 / 3.0))) * step;
  return ::exp(-::pow(x, T(1.035)) * T(1.0 / 4.7)) * T(2.011) -
         ::cos(x * T(0.5)) * ::exp(-::pow(x, T(1.2)) * T(1.0 / 2.73)) -
         e472 * T(0.011) + extra;
}

template <typename T>
__device__ __forceinline__ T shgmfunc(T x) {
  return ::log(::pow(x, T(1.50316886)) * T(0.00185777) + T(1)) *
         T(0.43793091);
}

// polsynch.polsynchth at one sample: e = [jI jQ jU jV aI aQ aU aV rQ rU rV]
template <typename T>
__device__ __forceinline__ void polsynchth(T nu, T n, T b, T te, T theta,
                                           const Params<T>& p, T* e) {
  const T thetae = te * p.k * p.inv_mc2 + T(1e-10);
  const T sth = ::fabs(::sin(theta));
  const T th2 = thetae * thetae;
  const T nuc = b * p.c3e * sth * p.inv_4pimc * th2 + T(1);
  const T xm = nu / nuc;
  const T pref = n * p.cpref / th2 * nu;
  const T x3 = ::pow(xm, T(1.0 / 3.0));
  const T ex = ::exp(x3 * T(-1.8899));
  const T r3 = recip(x3);
  const T r33 = recip(x3 * x3);
  const T iix = (r3 * T(1.92) + T(1) + r33 * T(0.9977)) * T(2.5651) * ex;
  const T iqx = (r3 * T(0.93193) + T(1) + r33 * T(0.499873)) * T(2.5651) * ex;
  const T ivx = (recip(xm) * T(1.81384) + r33 * T(3.42319) +
                 recip(::sqrt(xm)) * T(0.0292545) + r3 * T(2.03773)) * ex;
  const T ji = pref * iix;
  const T jq = pref * iqx;
  const T jv =
      recip(::tan(theta)) * p.cjv * n * T(0.5) / (th2 * thetae) * nu * ivx;
  const T bb = bnu(te, nu, p);
  e[0] = ji;
  e[1] = jq;
  e[2] = T(0);
  e[3] = jv;
  e[4] = ji / bb;
  e[5] = jq / bb;
  e[6] = T(0) / bb;
  e[7] = jv / bb;

  const T wp2 = n * p.c4pi * p.e2 * p.inv_m;
  const T omega0 = b * p.e * p.inv_mc;
  const T tpnu = nu * p.two_pi;
  const T arg = sth * p.sqrt2 * ((omega0 * T(1e3)) / tpnu);
  const T xarg = thetae * (arg == T(0) ? T(0) : ::sqrt(arg));
  const bool rel = thetae > T(1e-2);
  const T otn = omega0 / tpnu;
  const T wptn = wp2 / (tpnu * tpnu);
  const T jf = jffunc(xarg, p);
  T w11, w12;
  if (rel) {
    const T it = clamp_max(recip(thetae), T(150));
    const T k0 = besselk0(it);
    const T k1 = besselk1(it);
    const T k2 = k0 + recip(clamp_min(it, T(1e-37))) * T(2) * k1;
    const T gstep = ::tanh((thetae - T(1)) * T(1.0 / 0.05)) * T(0.5) + T(0.5);
    w11 = k1 / k2 + thetae * T(6);
    w12 = k0 / k2 - gstep * shgmfunc(xarg) / k2;
  } else {
    w11 = thetae * T(6) + T(1);
    w12 = T(1);
  }
  const T eps11m22 = jf * wptn * (otn * otn) * w11 * (sth * sth);
  const T eps12 = wptn * otn * ::cos(theta) * w12;
  e[8] = tpnu * T(0.5) * p.inv_c * eps11m22;
  e[9] = T(0);
  e[10] = tpnu * p.inv_c * eps12;
}

// The tetrad of one sample (tetrad.comoving_ortho without cosne) and
// render_rays' mask: false where the sample is not ok; else s2xi, c2xi,
// the pitch angle and the clamped redshift g.
template <typename T>
__device__ __forceinline__ bool tetrad(T r, T th, T alpha, T beta,
                                       const T* u, const T* b, const T* k,
                                       const Params<T>& p, T& s2xi, T& c2xi,
                                       T& ang, T& g) {
  // kerr.metric_cov
  const T cth = ::cos(th);
  const T sth = ::sin(th);
  const T d = (r - p.delta_p) * (r - p.delta_m);
  const T rho2 = r * r + p.aa * cth * cth;
  const T rra = r * r + p.aa;
  const T sigma = rra * rra - p.aa * d * sth * sth;
  Metric<T> gm;
  gm.tt = -(d - p.aa * sth * sth) / rho2;
  gm.tph = p.m2a * r * sth * sth / rho2;
  gm.rr = rho2 / d;
  gm.thth = rho2;
  gm.phph = sigma / rho2 * sth * sth;

  const T ut = u[0], ur = u[1], um = u[2], up = u[3];
  const T utc = gm.tt * ut + gm.tph * up;
  const T upc = gm.phph * up + gm.tph * ut;
  const T urc = gm.rr * ur;
  const T umc = gm.thth * um;

  // transport_perpk with the Walker-Penrose constants at the observer
  const T kap1 = alpha + p.kap_c;
  const T kap2 = -beta;
  const T k0 = k[0], k1 = k[1], k2 = k[2], k3 = k[3];
  const T gam1 = p.a * cth * k0 - p.aa * cth * sth * sth * k3;
  const T gam2 = r * rra * sth * k3 - p.a * r * sth * k0;
  const T gam3 = p.aa * cth * sth * sth * k1 - r * rra * sth * k2;
  const T del1 = r * k0 - r * p.a * sth * sth * k3;
  const T del2 = p.neg_a * cth * sth * rra * k3 + p.aa * sth * cth * k0;
  const T del3 = r * p.a * sth * sth * k1 + p.a * cth * sth * rra * k2;
  const T s33 = gm.phph * k3 + gm.tph * k0;
  const T denom = (gam2 * del1 - gam1 * del2) * s33 +
                  (gam3 * del2 - gam2 * del3) * gm.rr * k1 -
                  (gam3 * del1 - gam1 * del3) * gm.thth * k2;
  const T f1 = (gam2 * kap1 - del2 * kap2) * s33 -
               gm.thth * k2 * (gam3 * kap1 - del3 * kap2);
  const T f2 = (del1 * kap2 - gam1 * kap1) * s33 +
               gm.rr * k1 * (gam3 * kap1 - del3 * kap2);
  const T f3 = gm.thth * k2 * (gam1 * kap1 - del1 * kap2) -
               gm.rr * k1 * (gam2 * kap1 - del2 * kap2);
  const bool nz = ::fabs(denom) > T(0);
  T aa[4];
  aa[0] = T(0);
  if (kap1 == T(0) && kap2 == T(0)) {
    // pole-on: the basis along e_phi
    aa[1] = T(0);
    aa[2] = T(0);
    aa[3] = recip(::sqrt(gm.phph));
  } else {
    aa[1] = nz ? f1 / denom : f1;
    aa[2] = nz ? f2 / denom : f2;
    aa[3] = nz ? f3 / denom : f3;
  }

  // the Kulkarni+2011 comoving tetrad and frame_ok
  const T d2 = r * r + p.aa - T(2) * r;
  const T w = utc * ut + upc * up;
  const T v = umc * um + T(1);
  const T nr2 = -gm.rr * w * v;
  const T nm2 = gm.thth * v;
  const T np2 = -w * d2 * (sth * sth);
  if (!(nr2 > T(0) && nm2 > T(0) && np2 > T(0))) return false;
  const T snr = ::sqrt(nr2), snm = ::sqrt(nm2), snp = ::sqrt(np2);
  const T ekt[4] = {-ut, -ur, -um, -up};
  const T ekr[4] = {urc * ut / snr, -w / snr, T(0), urc * up / snr};
  const T ekm[4] = {umc * ut / snm, umc * ur / snm, v / snm, umc * up / snm};
  const T ekp[4] = {upc / snp, T(0), T(0), -utc / snp};
  const T bh[4] = {dot(gm, ekt, b), dot(gm, ekr, b), dot(gm, ekm, b),
                   dot(gm, ekp, b)};
  const T kh[4] = {dot(gm, ekt, k), dot(gm, ekr, k), dot(gm, ekm, k),
                   dot(gm, ekp, k)};
  const T ah[4] = {dot(gm, ekt, aa), dot(gm, ekr, aa), dot(gm, ekm, aa),
                   dot(gm, ekp, aa)};

  const T knorm = kh[1] * kh[1] + kh[2] * kh[2] + kh[3] * kh[3];
  if (!(knorm > T(0) && ::fabs(kh[0]) > T(0))) return false;
  const T kt = kh[0];
  // the basis projected perpendicular to k with the null condition
  const T aah[3] = {ah[1] - kh[1] * ah[0] / kt, ah[2] - kh[2] * ah[0] / kt,
                    ah[3] - kh[3] * ah[0] / kt};
  const T sk = ::sqrt(knorm);
  const T bbh[3] = {-(aah[1] * kh[3] - aah[2] * kh[2]) / sk,
                    -(aah[2] * kh[1] - aah[0] * kh[3]) / sk,
                    -(aah[0] * kh[2] - aah[1] * kh[1]) / sk};

  const T bdotb = dot(gm, b, b);
  const T bdotk = bh[1] * kh[1] + bh[2] * kh[2] + bh[3] * kh[3];
  // (bsp * aahat).sum(-1) in the order of torch's reduction over a
  // trailing 3 on the card, (x0 + x2) + x1 (two threads a row: x0 + x2,
  // then x1 by shuffle; read on an H100 on 4.2M rows)
  const T aadotbp = bh[1] * aah[0] + bh[3] * aah[2] + bh[2] * aah[1];
  const T bpdotbb = bh[1] * bbh[0] + bh[3] * bbh[2] + bh[2] * bbh[1];
  const T nrm = aadotbp * aadotbp + bpdotbb * bpdotbb;
  T angnorm;
  if (bdotb > T(0)) {
    const T safenrm = nrm > T(0) ? nrm : T(1);
    s2xi = T(-2) * aadotbp * bpdotbb / safenrm;
    c2xi = (bpdotbb * bpdotbb - aadotbp * aadotbp) / safenrm;
    angnorm = bdotk / sk / ::sqrt(bdotb);
  } else {
    s2xi = T(0);
    c2xi = T(1);
    angnorm = T(0.5);
  }
  const T c = isnan(angnorm)
                  ? angnorm
                  : (angnorm < p.ang_lo ? p.ang_lo
                                        : (angnorm > p.ang_hi ? p.ang_hi
                                                              : angnorm));
  ang = ::acos(c);
  g = recip(kt);
  if (!(isfinite(g) && isfinite(s2xi) && isfinite(c2xi) && isfinite(ang)))
    return false;
  // the float32 leg (prec="mixed") alone: the horizon cut
  if constexpr (sizeof(T) == 4) {
    if (!(r - p.rh > p.hor)) return false;
  }
  g = g < T(1e-8) ? T(1e-8) : (g > T(1e8) ? T(1e8) : g);
  return true;
}

template <typename T>
__device__ __forceinline__ bool all_finite(const T* v) {
  return isfinite(v[0]) && isfinite(v[1]) && isfinite(v[2]) &&
         isfinite(v[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    render(const T* __restrict__ x, const T* __restrict__ kv,
           const T* __restrict__ uv, const T* __restrict__ bv,
           const bool* __restrict__ valid, const T* __restrict__ alpha,
           const T* __restrict__ beta, const T* __restrict__ ncgs,
           const T* __restrict__ bcgs, const T* __restrict__ tcgs,
           T* __restrict__ jout, T* __restrict__ kout,
           bool* __restrict__ okout, long long n, int npts, Params<T> p,
           bool rotate) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (i >= n) return;
  const long long pix = i / npts;
  T j[4] = {T(0), T(0), T(0), T(0)};
  T K[7] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  T u[4], b[4], k[4];
  for (int c = 0; c < 4; ++c) {
    u[c] = uv[4 * i + c];
    b[c] = bv[4 * i + c];
    k[c] = kv[4 * i + c];
  }
  T s2xi, c2xi, ang, g;
  const bool ok = valid[i] && all_finite(u) && all_finite(b) &&
                  tetrad(x[4 * i + 1], x[4 * i + 2], alpha[pix], beta[pix],
                         u, b, k, p, s2xi, c2xi, ang, g);
  if (ok) {
    T e[11];
    polsynchth(recip(g) * p.fghz, ncgs[i], bcgs[i], tcgs[i], ang, p, e);
    for (int c = 0; c < 7; ++c) e[4 + c] = e[4 + c] * p.mult[c];
    for (int c = 0; c < 11; ++c)
      if (!isfinite(e[c])) e[c] = T(0);
    if (rotate) {
      j[0] = e[0];
      j[1] = c2xi * e[1] - s2xi * e[2];
      j[2] = s2xi * e[1] + c2xi * e[2];
      j[3] = e[3];
      K[0] = e[4];
      K[1] = c2xi * e[5] - s2xi * e[6];
      K[2] = s2xi * e[5] + c2xi * e[6];
      K[3] = e[7];
      K[4] = c2xi * e[8] - s2xi * e[9];
      K[5] = s2xi * e[8] + c2xi * e[9];
      K[6] = e[10];
    } else {
      for (int c = 0; c < 4; ++c) j[c] = e[c];
      for (int c = 0; c < 7; ++c) K[c] = e[4 + c];
    }
    const T g2 = g * g;
    for (int c = 0; c < 4; ++c) j[c] = j[c] * g2 * p.lbh;
    for (int c = 0; c < 7; ++c) K[c] = K[c] / g * p.lbh;
  }
  for (int c = 0; c < 4; ++c) jout[4 * i + c] = j[c];
  for (int c = 0; c < 7; ++c) kout[7 * i + c] = K[c];
  okout[i] = ok;
}

template <typename T>
int launch(const T* x, const T* k, const T* u, const T* b, const bool* valid,
           const T* alpha, const T* beta, const T* ncgs, const T* bcgs,
           const T* tcgs, T* j, T* kout, bool* ok, long long npix, int npts,
           const T* params, int rotate, void* stream) {
  if (npix < 0 || npts < 0 || params == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Params<T> p;
  T* dst = reinterpret_cast<T*>(&p);
  for (int c = 0; c < kNumParams; ++c) dst[c] = params[c];
  const long long n = npix * npts;
  if (n > 0)
    render<T><<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, k, u, b, valid, alpha, beta, ncgs, bcgs, tcgs, j, kout, ok, n,
        npts, p, rotate != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int render_polsynchth_num_params() { return kNumParams; }

extern "C" int render_polsynchth_f64(
    const double* x, const double* k, const double* u, const double* b,
    const bool* valid, const double* alpha, const double* beta,
    const double* ncgs, const double* bcgs, const double* tcgs, double* j,
    double* kout, bool* ok, long long npix, int npts, const double* params,
    int rotate, void* stream) {
  return launch(x, k, u, b, valid, alpha, beta, ncgs, bcgs, tcgs, j, kout,
                ok, npix, npts, params, rotate, stream);
}

extern "C" int render_polsynchth_f32(
    const float* x, const float* k, const float* u, const float* b,
    const bool* valid, const float* alpha, const float* beta,
    const float* ncgs, const float* bcgs, const float* tcgs, float* j,
    float* kout, bool* ok, long long npix, int npts, const float* params,
    int rotate, void* stream) {
  return launch(x, k, u, b, valid, alpha, beta, ncgs, bcgs, tcgs, j, kout,
                ok, npix, npts, params, rotate, stream);
}
