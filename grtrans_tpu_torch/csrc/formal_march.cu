// The formal / lsoda Stokes march of observed_stokes in one launch, for
// Hopper (sm_90a).
//
//   out[p] = M_0 ... M_{ncell-2} M_{ncell-1} I0[p],   M_c: I -> O_c I + p_c
//
// Replaces grtrans_tpu/integrate/solvers.py:_seq_march (:532), an
// XLA-fused lax.scan over the cells with each cell's matricant and
// emission built inside the scan body; there is no Pallas kernel for it.
// Its plain PyTorch twin is grtrans_tpu_torch/integrate/solvers.py:_march
// fed by _formal_maps, which on the card issued ~1,300 torch launches for
// each block of 8 cells.  This kernel computes what formal_solve(...,
// profile=False) computes after its prologue (passivity_clamp and
// _cell_tau_mask stay in torch), branch for branch:
//  * each pixel marches far to near over its cells (cell c spans samples
//    c, the near end, and c + 1, the far end, in trace order); a cell is
//    cut into `substeps` with linearly interpolated coefficients, the far
//    substep applied first, as _formal_maps does (substeps 1: midpoint
//    opacity, the samples' emission);
//  * a substep's map I -> O I + p is applied to the running Stokes
//    4-vector in registers (a 4x4 matvec, never a 4x4 x 4x4 composition);
//    cells that cell_ok masks are the identity and are skipped, so are the
//    masked cells beyond the photosphere, and their samples are never read;
//  * O is _calc_O: _lam12 with the product form of the small root, the
//    degenerate test, the clipped exp / expm1 forms, the phase rule past
//    phase_max (cos = sin = 0; 9.0e12 rad in float64), `bad` as
//    !(max|O| <= 1 + 1e-6) so that NaN lands in it, the cubic nilpotent
//    fallback, then exp(-aI dx) I;
//  * p is _cell_emission: the scale by the largest |coefficient|, the
//    adjugate inverse with its `good` test (_inv4), the exact
//    (I - O) K^-1 j_mid for deep cells (zmax > 0.3), the trapezoid for deep
//    singular ones, the 4-term Taylor form otherwise (here in Horner form
//    on vectors: Z (a - Z (b - Z c)) with Z = K dx).  Each thread computes
//    only the branch its substep takes.
// Affine maps compose associatively, so the result differs from the
// twin's block composition by rounding alone.
//
// Instantiations: float64 (the cells), and float32 for prec="mixed", whose
// Faraday phase is formed from the float64 step dlam64 and reduced mod
// 2 pi before the float32 trig, as _calc_O(dx64=) does.
//
// What bounds it on this card: at 256^2 pixels x 400 points the march
// reads 12 values a sample (lam, j 4, K 7) and a mask byte a cell, 2.5 GB,
// 0.76 ms at 3.35 TB/s; its arithmetic is some 750 float64 operations a
// substep, an estimate from this source and not a count (exp x 3, expm1,
// sincos, three square roots and three divides, each a software sequence
// of ~25 on the FP64 pipe, besides ~500 for the 4x4 algebra; more in deep
// cells, whose adjugate inverse adds 16 divides), 3.9e10 at two substeps
// over 26.1M cells, 2.3 ms at the card's 16.7e12 unfused FP64 operations
// a second (its 33.5 TFLOP/s counts a fused multiply-add as two, and this
// kernel is built without them).  FP64 issue and the latency of those
// dependent sequences bind, not bytes.  The design: one thread a pixel, every intermediate in
// registers, no shared memory, no synchronisation; the far sample of a
// cell is the near sample of the one before, so each sample is read once,
// and a thread's reads walk its own ray (the lines stay in L1/L2 between
// neighbouring cells).  Measured on an H100 (700 W) on the FFJET frame's
// 256^2 x 400 lsoda operands: float64 7.34 ms at 200 registers a thread
// (no spill; 2 blocks of 128 an SM, two waves), 6.49 ms with
// __launch_bounds__(128, 3) (168 registers, 96 bytes spilled to L1; 3
// blocks an SM), 7.50 ms with (128, 4) (128 registers, one wave, 336
// bytes spilled): the kernel keeps (128, 3).  float32 (106 registers)
// 4.4 ms under all three.  The torch march took 845 ms on the same
// operands, so splitting rays into segments (more threads, a 4x4
// composition a cell instead of a matvec) is not worth its arithmetic.
//
// Built with -fmad=false (ops/formal_march.py): no product and sum are
// fused, so each rounds as torch's separate operations round it.  A
// cell's Faraday phase lam2 dx is resolved up to phase_max (9.0e12 rad),
// where one unit roundoff of lam2 moves the phase by 1e-3 rad: a fused
// multiply-add in _lam12 or in the coefficients' interpolation would turn
// the twin's rotation by as much, far above the benchmark's image limit of
// 1e-9.  Measured cost: 7.29 against 7.13 ms (float64), 4.43 against
// 3.82 ms (float32).  The build keeps ptxas's register and spill report
// in the library's .log.
//
// C interface (ctypes): formal_march_f64 / formal_march_f32 launch on the
// given stream and return cudaGetLastError().  Operands, all contiguous:
// lam (npix, npts), j (npix, npts, 4), K (npix, npts, 7) of the dtype;
// ok (npix, npts - 1) bytes, 0 or 1; I0 (npix, 4) or null (zero); dlam64
// (npix, npts - 1) float64, required by _f32 and null for _f64; out
// (npix, 4).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>
#include <limits>

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 3;  // blocks an SM: 168 registers a thread

// _calc_O's and _cell_emission's constants in the march's dtype, as torch
// casts the Python floats of solvers.py.
template <typename T>
struct Consts {
  T eps15;      // eps ** 1.5: _lam12's regularizer
  T tiny;       // float32's smallest normal, _TINY
  T sqrt_tiny;  // _SQRT_TINY
  T dthr;       // 10 sqrt(eps): the degenerate matricant
  T lo, hi;     // exp's clip, -0.95 log(max) and 60
  T obound;     // 1 + 1e-6: a passive O
  T eps100;     // 100 eps: _inv4's determinant test
  T deep;       // 0.3: zmax past which a cell is deep
  double phase_max;  // float64's (the phase is formed in float64)
};

template <typename T>
Consts<T> make_consts() {
  const double eps = std::numeric_limits<T>::epsilon();
  const double tiny = std::numeric_limits<float>::min();
  Consts<T> c;
  c.eps15 = T(std::pow(eps, 1.5));
  c.tiny = T(tiny);
  c.sqrt_tiny = T(std::sqrt(tiny));
  c.dthr = T(10.0 * std::sqrt(eps));
  c.lo = T(-0.95 * std::log(double(std::numeric_limits<T>::max())));
  c.hi = T(60.0);
  c.obound = T(1.0 + 1e-6);
  c.eps100 = T(100.0 * eps);
  c.deep = T(0.3);
  c.phase_max = 1e-3 * 2.0 / std::numeric_limits<double>::epsilon();
  return c;
}

// torch's clamp and maximum: a NaN goes through
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
template <typename T>
__device__ __forceinline__ T nanmax(T m, T x) {
  return (x > m || x != x) ? x : m;
}

// max|m| over 16 entries, NaN if any is
template <typename T>
__device__ __forceinline__ T absmax16(const T* m) {
  T mx = fabs(m[0]);
#pragma unroll
  for (int i = 1; i < 16; ++i) mx = nanmax(mx, T(fabs(m[i])));
  return mx;
}

// y = m v, m row-major 4x4
template <typename T>
__device__ __forceinline__ void matvec(const T* m, const T* v, T* y) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    y[i] = m[4 * i] * v[0] + m[4 * i + 1] * v[1] + m[4 * i + 2] * v[2] +
           m[4 * i + 3] * v[3];
}

// c = a b, row-major 4x4
template <typename T>
__device__ __forceinline__ void matmul(const T* a, const T* b, T* c) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      c[4 * i + k] = a[4 * i] * b[k] + a[4 * i + 1] * b[4 + k] +
                     a[4 * i + 2] * b[8 + k] + a[4 * i + 3] * b[12 + k];
}

// The Mueller opacity matrix of (aI, aQ, aU, aV), (rQ, rU, rV), times x
template <typename T>
__device__ __forceinline__ void opacity(const T* a, const T* r, T x, T* m) {
  m[0] = a[0] * x;  m[1] = a[1] * x;  m[2] = a[2] * x;  m[3] = a[3] * x;
  m[4] = a[1] * x;  m[5] = a[0] * x;  m[6] = r[2] * x;  m[7] = -r[1] * x;
  m[8] = a[2] * x;  m[9] = -r[2] * x; m[10] = a[0] * x; m[11] = r[0] * x;
  m[12] = a[3] * x; m[13] = r[1] * x; m[14] = -r[0] * x; m[15] = a[0] * x;
}

template <typename T>
struct Lam12 {
  T a2, p2, ap, lam1, lam2;
};

// _lam12: the two eigenvalue magnitudes, the small root from the product
template <typename T>
__device__ __forceinline__ Lam12<T> lam12(const T* a, const T* r,
                                          const Consts<T>& k) {
  Lam12<T> o;
  o.a2 = a[1] * a[1] + a[2] * a[2] + a[3] * a[3];
  o.p2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
  o.ap = a[1] * r[0] + a[2] * r[1] + a[3] * r[2];
  const T scale = k.eps15 * (o.a2 + o.p2) + k.tiny;
  const T h = (o.a2 - o.p2) / T(2);
  const T rt = sqrt(h * h + o.ap * o.ap + scale * scale);
  const T big = rt + fabs(h);
  const T big_sq = big + scale;
  const T small_sq = (o.ap * o.ap + scale * scale) / (big < k.tiny ? k.tiny
                                                                   : big);
  o.lam1 = sqrt(h >= T(0) ? big_sq : small_sq);
  o.lam2 = sqrt(h >= T(0) ? small_sq : big_sq);
  return o;
}

template <typename T, bool MIXED>
__device__ __forceinline__ void phase_trig(T lam2, T dx, double dx64,
                                           const Consts<T>& k, T* c, T* s) {
  double ph = MIXED ? double(lam2) * dx64 : double(lam2 * dx);
  if (fabs(ph) > k.phase_max) {
    *c = *s = T(0);
    return;
  }
  if constexpr (MIXED) {
    const double two_pi = 2.0 * 3.14159265358979323846;
    const float phf = float(ph - two_pi * floor(ph / two_pi));
    float sf, cf;
    sincosf(phf, &sf, &cf);
    *c = T(cf);
    *s = T(sf);
  } else {
    double sd, cd;
    sincos(ph, &sd, &cd);
    *c = T(cd);
    *s = T(sd);
  }
}

// _calc_O: O = exp(-K dx) of the constant opacity matrix (a, r)
template <typename T, bool MIXED>
__device__ __forceinline__ void calc_O(const T* a, const T* r, T dx,
                                       double dx64, const Consts<T>& k,
                                       T* O) {
  const Lam12<T> L = lam12(a, r, k);
  const T adx = fabs(dx);
  const bool degen = (L.lam1 * adx < k.dthr) && (L.lam2 * adx < k.dthr);
  const T eno = exp(clip(-a[0] * dx, k.lo, k.hi));
  bool need_poly = degen;
  if (!degen) {
    // the eigen form; a non-degenerate cell's roots are L's
    const T aq = a[1], au = a[2], av = a[3];
    const T rq = r[0], ru = r[1], rv = r[2];
    const T lam1 = L.lam1, lam2 = L.lam2;
    const T theta = lam1 * lam1 + lam2 * lam2;
    const T ith = T(1) / (theta > k.sqrt_tiny ? theta : T(1));
    const T sig = L.ap < T(0) ? T(-1) : T(1);
    const T arg_p = clip((lam1 - a[0]) * dx, k.lo, k.hi);
    const T arg_m = clip(-(lam1 + a[0]) * dx, k.lo, k.hi);
    const T ep = exp(arg_p);
    const T ecp = T(0.5) * (ep + exp(arg_m));
    const T ecm = T(-0.5) * ep * expm1(arg_m - arg_p);
    T cs, sn;
    phase_trig<T, MIXED>(lam2, dx, dx64, k, &cs, &sn);
    cs *= eno;
    sn *= eno;
    const T A = T(0.5) * (ecp + cs);
    const T B = sn * ith;
    const T C = ecm * ith;
    const T D = (ecp - cs) * ith;
    const T sl1 = sig * lam1, sl2 = sig * lam2;
    // the off-diagonal entries of M2, M3 (rows 0-1, the rest by symmetry)
    const T m2_01 = lam2 * aq - sl1 * rq, m2_02 = lam2 * au - sl1 * ru;
    const T m2_03 = lam2 * av - sl1 * rv, m2_12 = sl1 * av + lam2 * rv;
    const T m2_13 = -sl1 * au - lam2 * ru, m2_23 = sl1 * aq + lam2 * rq;
    const T m3_01 = lam1 * aq + sl2 * rq, m3_02 = lam1 * au + sl2 * ru;
    const T m3_03 = lam1 * av + sl2 * rv, m3_12 = -sl2 * av + lam1 * rv;
    const T m3_13 = sl2 * au - lam1 * ru, m3_23 = -sl2 * aq + lam1 * rq;
    const T hp = (L.a2 + L.p2) / T(2);
    const T c1 = av * ru - au * rv, c2 = aq * rv - av * rq;
    const T c3 = au * rq - aq * ru;
    const T q01 = aq * au + rq * ru, q02 = av * aq + rv * rq;
    const T q12 = au * av + ru * rv;
    O[0] = A + D * hp;
    O[1] = (-B * m2_01 - C * m3_01) + D * c1;
    O[2] = (-B * m2_02 - C * m3_02) + D * c2;
    O[3] = (-B * m2_03 - C * m3_03) + D * c3;
    O[4] = (-B * m2_01 - C * m3_01) - D * c1;
    O[5] = A + D * (aq * aq + rq * rq - hp);
    O[6] = (-B * m2_12 - C * m3_12) + D * q01;
    O[7] = (-B * m2_13 - C * m3_13) + D * q02;
    O[8] = (-B * m2_02 - C * m3_02) - D * c2;
    O[9] = (B * m2_12 + C * m3_12) + D * q01;
    O[10] = A + D * (au * au + ru * ru - hp);
    O[11] = (-B * m2_23 - C * m3_23) + D * q12;
    O[12] = (-B * m2_03 - C * m3_03) - D * c3;
    O[13] = (B * m2_13 + C * m3_13) + D * q02;
    O[14] = (B * m2_23 + C * m3_23) + D * q12;
    O[15] = A + D * (av * av + rv * rv - hp);
    need_poly = !(absmax16(O) <= k.obound);
  }
  if (need_poly) {
    // I - Z + Z^2/2 - Z^3/6 of the polarized part, else scalar attenuation
    const T a0[4] = {T(0), a[1], a[2], a[3]};
    T Z[16], Z2[16], Z3[16];
    opacity(a0, r, dx, Z);
    matmul(Z, Z, Z2);
    matmul(Z2, Z, Z3);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      O[i] = eno * ((((i % 5) == 0 ? T(1) : T(0)) - Z[i] + Z2[i] / T(2)) -
                    Z3[i] / T(6));
    if (!(absmax16(O) <= k.obound)) {
#pragma unroll
      for (int i = 0; i < 16; ++i) O[i] = (i % 5) == 0 ? eno : T(0);
    }
  }
}

// _inv4's adjugate and determinant of m; returns whether the determinant
// is large enough to trust, and then iK = adj / det
template <typename T>
__device__ __forceinline__ bool inv4(const T* m, const Consts<T>& k, T* iK) {
#define E(i, j) m[4 * (i) + (j)]
  const T s0 = E(0, 0) * E(1, 1) - E(1, 0) * E(0, 1);
  const T s1 = E(0, 0) * E(1, 2) - E(1, 0) * E(0, 2);
  const T s2 = E(0, 0) * E(1, 3) - E(1, 0) * E(0, 3);
  const T s3 = E(0, 1) * E(1, 2) - E(1, 1) * E(0, 2);
  const T s4 = E(0, 1) * E(1, 3) - E(1, 1) * E(0, 3);
  const T s5 = E(0, 2) * E(1, 3) - E(1, 2) * E(0, 3);
  const T c5 = E(2, 2) * E(3, 3) - E(3, 2) * E(2, 3);
  const T c4 = E(2, 1) * E(3, 3) - E(3, 1) * E(2, 3);
  const T c3 = E(2, 1) * E(3, 2) - E(3, 1) * E(2, 2);
  const T c2 = E(2, 0) * E(3, 3) - E(3, 0) * E(2, 3);
  const T c1 = E(2, 0) * E(3, 2) - E(3, 0) * E(2, 2);
  const T c0 = E(2, 0) * E(3, 1) - E(3, 0) * E(2, 1);
  const T det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0;
  iK[0] = E(1, 1) * c5 - E(1, 2) * c4 + E(1, 3) * c3;
  iK[1] = -E(0, 1) * c5 + E(0, 2) * c4 - E(0, 3) * c3;
  iK[2] = E(3, 1) * s5 - E(3, 2) * s4 + E(3, 3) * s3;
  iK[3] = -E(2, 1) * s5 + E(2, 2) * s4 - E(2, 3) * s3;
  iK[4] = -E(1, 0) * c5 + E(1, 2) * c2 - E(1, 3) * c1;
  iK[5] = E(0, 0) * c5 - E(0, 2) * c2 + E(0, 3) * c1;
  iK[6] = -E(3, 0) * s5 + E(3, 2) * s2 - E(3, 3) * s1;
  iK[7] = E(2, 0) * s5 - E(2, 2) * s2 + E(2, 3) * s1;
  iK[8] = E(1, 0) * c4 - E(1, 1) * c2 + E(1, 3) * c0;
  iK[9] = -E(0, 0) * c4 + E(0, 1) * c2 - E(0, 3) * c0;
  iK[10] = E(3, 0) * s4 - E(3, 1) * s2 + E(3, 3) * s0;
  iK[11] = -E(2, 0) * s4 + E(2, 1) * s2 - E(2, 3) * s0;
  iK[12] = -E(1, 0) * c3 + E(1, 1) * c1 - E(1, 2) * c0;
  iK[13] = E(0, 0) * c3 - E(0, 1) * c1 + E(0, 2) * c0;
  iK[14] = -E(3, 0) * s3 + E(3, 1) * s1 - E(3, 2) * s0;
  iK[15] = E(2, 0) * s3 - E(2, 1) * s1 + E(2, 2) * s0;
#undef E
  const bool good = fabs(det) > k.eps100 * absmax16(iK) + k.tiny;
  if (good) {
#pragma unroll
    for (int i = 0; i < 16; ++i) iK[i] = iK[i] / det;
  }
  return good;
}

// _cell_emission: p of the substep map, given its O
template <typename T>
__device__ __forceinline__ void emission(const T* O, const T* a, const T* r,
                                         const T* jn, const T* jf, T dl,
                                         const Consts<T>& k, T* p) {
  T s = fabs(a[0]);
  s = nanmax(s, T(fabs(a[1])));
  s = nanmax(s, T(fabs(a[2])));
  s = nanmax(s, T(fabs(a[3])));
  s = nanmax(s, T(fabs(r[0])));
  s = nanmax(s, T(fabs(r[1])));
  s = nanmax(s, T(fabs(r[2])));
  s = s < k.sqrt_tiny ? k.sqrt_tiny : s;
  const T ia0 = T(1) / s;
  const T zmax = s * dl;
  T Kn[16];
  if (zmax > k.deep) {
    opacity(a, r, ia0, Kn);
    T iK[16];
    if (inv4(Kn, k, iK)) {
      // p = (I - O) K^-1 j_mid
      T v[4], S[4], OS[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = T(0.5) * (jn[i] + jf[i]) * ia0;
      matvec(iK, v, S);
      matvec(O, S, OS);
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = S[i] - OS[i];
    } else {
      // the trapezoid
      T Oj[4];
      matvec(O, jf, Oj);
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = T(0.5) * dl * (Oj[i] + jn[i]);
    }
    return;
  }
  // dl (Wn jn + Wf jf), Wn = I/2 - Z/6 + Z^2/24 - Z^3/120,
  // Wf = I/2 - Z/3 + Z^2/8 - Z^3/30, Z = K dl, in Horner form
  T a_[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a_[i] = a[i] * ia0;
  const T r_[3] = {r[0] * ia0, r[1] * ia0, r[2] * ia0};
  opacity(a_, r_, zmax, Kn);
  T u[4], Zu[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = jn[i] / T(120) + jf[i] / T(30);
  matvec(Kn, u, Zu);
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = (jn[i] / T(24) + jf[i] / T(8)) - Zu[i];
  matvec(Kn, u, Zu);
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = (jn[i] / T(6) + jf[i] / T(3)) - Zu[i];
  matvec(Kn, u, Zu);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = dl * (T(0.5) * (jn[i] + jf[i]) - Zu[i]);
}

// One substep: I <- O I + p
template <typename T, bool MIXED>
__device__ __forceinline__ void substep(T* I, const T* a, const T* r,
                                        const T* jn, const T* jf, T dx,
                                        double dx64, const Consts<T>& k) {
  T O[16], p[4], OI[4];
  calc_O<T, MIXED>(a, r, dx, dx64, k, O);
  emission(O, a, r, jn, jf, dx, k, p);
  matvec(O, I, OI);
#pragma unroll
  for (int i = 0; i < 4; ++i) I[i] = OI[i] + p[i];
}

template <typename T>
struct Sample {
  T lam, j[4], K[7];
};

template <typename T>
__device__ __forceinline__ void load(Sample<T>& s, const T* lam, const T* j,
                                     const T* K, long long i) {
  s.lam = __ldg(lam + i);
#pragma unroll
  for (int c = 0; c < 4; ++c) s.j[c] = __ldg(j + 4 * i + c);
#pragma unroll
  for (int c = 0; c < 7; ++c) s.K[c] = __ldg(K + 7 * i + c);
}

template <typename T, bool MIXED>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    formal_march(const T* __restrict__ lam, const T* __restrict__ j,
                 const T* __restrict__ K, const uint8_t* __restrict__ ok,
                 const T* __restrict__ I0, const double* __restrict__ dlam64,
                 T* __restrict__ out, long long npix, int npts, int substeps,
                 Consts<T> k) {
  const long long pix = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (pix >= npix) return;
  const int ncell = npts - 1;
  const long long row = pix * npts;
  const uint8_t* okp = ok + pix * ncell;
  T I[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) I[i] = I0 ? I0[4 * pix + i] : T(0);
  Sample<T> nr, fr;
  int held = -1;  // the sample in `fr`
  for (int c = ncell - 1; c >= 0; --c) {
    if (!okp[c]) continue;
    if (held != c + 1) load(fr, lam, j, K, row + c + 1);
    load(nr, lam, j, K, row + c);
    const T d = fr.lam - nr.lam;
    const double d64 = MIXED ? dlam64[pix * ncell + c] : 0.0;
    T a[4], r[3];
    if (substeps == 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = T(0.5) * (nr.K[i] + fr.K[i]);
#pragma unroll
      for (int i = 0; i < 3; ++i) r[i] = T(0.5) * (nr.K[4 + i] + fr.K[4 + i]);
      substep<T, MIXED>(I, a, r, nr.j, fr.j, d, d64, k);
    } else {
      const T dsub = d / T(substeps);
      const double dsub64 = d64 / substeps;
      for (int s = substeps - 1; s >= 0; --s) {
        const double f = (s + 0.5) / substeps;
        const double e0 = double(s) / substeps, e1 = double(s + 1) / substeps;
        const T wn = T(1 - f), wf = T(f);
        T jn[4], jf[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = nr.K[i] * wn + fr.K[i] * wf;
          jn[i] = nr.j[i] * T(1 - e0) + fr.j[i] * T(e0);
          jf[i] = nr.j[i] * T(1 - e1) + fr.j[i] * T(e1);
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) r[i] = nr.K[4 + i] * wn + fr.K[4 + i] * wf;
        substep<T, MIXED>(I, a, r, jn, jf, dsub, dsub64, k);
      }
    }
    fr = nr;
    held = c;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) out[4 * pix + i] = I[i];
}

template <typename T, bool MIXED>
int launch(const T* lam, const T* j, const T* K, const uint8_t* ok,
           const T* I0, const double* dlam64, T* out, long long npix,
           int npts, int substeps, void* stream) {
  if (npts < 1 || substeps < 1 || (MIXED && dlam64 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (npix > 0) {
    const long long blocks = (npix + kThreads - 1) / kThreads;
    formal_march<T, MIXED><<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        lam, j, K, ok, I0, dlam64, out, npix, npts, substeps,
        make_consts<T>());
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int formal_march_f64(const double* lam, const double* j,
                                const double* K, const uint8_t* ok,
                                const double* I0, const double* dlam64,
                                double* out, long long npix, int npts,
                                int substeps, void* stream) {
  if (dlam64 != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<double, false>(lam, j, K, ok, I0, nullptr, out, npix, npts,
                               substeps, stream);
}

extern "C" int formal_march_f32(const float* lam, const float* j,
                                const float* K, const uint8_t* ok,
                                const float* I0, const double* dlam64,
                                float* out, long long npix, int npts,
                                int substeps, void* stream) {
  return launch<float, true>(lam, j, K, ok, I0, dlam64, out, npix, npts,
                             substeps, stream);
}
