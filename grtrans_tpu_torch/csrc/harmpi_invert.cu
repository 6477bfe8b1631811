// HARMPI's jetcoords sample inversion, r -> x1 and th -> x2, as two
// launches a sampled camera, for Hopper (sm_90a), in float64 and float32.
//
//   x1[i] = bisection of calcrmks(x1) = r[i] on [lo, hi]
//   x2[i] = bisection of calcthmksbl3(x2, r[i]) = th[i] on [-1, 1]
//
// Replaces grtrans_tpu/fluid/harmpi.py:x1_of_r (:158) and x2_of_th_bl3
// (:251), fixed-count bisection loops that XLA fuses; there is no Pallas
// kernel for them.  Their plain PyTorch twin is
// grtrans_tpu_torch/fluid/harmpi.py:x1_of_r_twin / x2_of_th_bl3_twin
// (fluid/thickdisk.py:bisect over calcrmks / calcthmksbl3), which on the
// card issued 14,468 elementwise launches a frame over the frame's 26.2M
// samples, each a pass over device memory for a few operations.  x2 is the
// map without the cylindrification, as grtrans inverts it
// (transformbl2mksbl3 :526).
//
// One thread a sample does what the twin's torch operations do, operation
// for operation and in their order, with three differences that change no
// bit of the result:
//  * the r-only factors of calcthmksbl3 (r1disk, r2disk, r1jet, r2jet and
//    their powers ror0nudisk, ror0nujet: four `mins`, four powers) are
//    computed once before the loop, not once a step;
//  * of each torch.where (ftr, fangle, thetaofx2, calcrmks' x1 > xbr) only
//    the branch that it selects is computed, and the tangent of thetaofx2
//    once for the disk and the jet, which share its argument;
//  * where the blend weight fac is 0 (|x2| <= fracdisk) or 1 (|x2| >=
//    1 - fracjet), the side it weights by 0 is left out: fac * thetajet +
//    (1 - fac) * thetadisk is then the other side (or a zero of the other
//    sign, which compares alike), provided the left-out side is finite.  A
//    side is finite for every x2 when its ror0nu is finite and not 0 (the
//    tangent is finite, so its quotient by or product with ror0nu is never
//    NaN, and an infinite one has a finite arctangent); a sample where that
//    fails (r = 0, r not finite, a power that overflows) computes both, as
//    the twin does.
// lo, hi and mid stay in registers, with the twin's test f(mid) > target
// and its updates.  The loop stops once mid equals lo or hi: the update
// then leaves the state as it was or sets lo = hi, and from either every
// later step changes nothing, so the result is the same bits.
//
// Torch's arithmetic on the card, which the kernel follows in the
// operands' type T (double, or float under prec="mixed"): a Python float
// meets a tensor cast to T; a tensor divided by a Python float is
// multiplied by the float's reciprocal, computed on the host in double and
// cast to T (the wrapper passes it); a power by a Python float takes
// torch's special cases (0, 1, 0.5, -0.5, -1, 2, 3, -2), torch_pow below;
// the transcendental functions are the overloads of T that torch's kernels
// call (expf, sinf, tanf, atanf, powf ... for float).  Built with
// -fmad=false (ops/harmpi_invert.py): no product and sum are fused, so each
// rounds as torch's separate operations round it.
//
// What bounds it: operations.  A sample reads r (and th) and writes x1
// (x2): 2 (3) operands, 1.05 GB in float64 for both over a 26.2M-sample
// frame, 0.31 ms at 3.35 TB/s.  Its arithmetic a step, counted from this
// source with a transcendental taken as ~25 operations of its software
// sequence (an estimate): x1, an exp and a few adds, a power more above
// xbr; x2, a tan and one atan, and on the ftr band (0 < fac < 1) a cos, two
// sin and the second atan with the blend; once a sample, the r-only
// factors (12 sin in four mins, four powers).  How many steps run before
// the exit, and how many of x2's lie on the band, depend on the samples:
// chip_smoke.py's phase 29 replays the bisections on a frame's samples to
// count them, and from them the frame's operations and the bound.  The
// design: one thread a sample, every intermediate in registers, no shared
// memory; a warp's samples are neighbouring points of neighbouring rays,
// so its branches mostly agree.
//
// C interface (ctypes): harmpi_x1_of_r_{f64,f32} / harmpi_x2_of_th_{f64,
// f32} launch on the given stream and return cudaGetLastError().  r, th
// and the output are n contiguous values of T; params points to the host
// array of kNumParams values of T that ops/harmpi_invert.py:kernel_params
// makes, in the order of struct Params.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr double kPi = 3.141592653589793;  // Python's math.pi

// The scalars of BL3Params as the twin's torch operations receive them.
template <typename T>
struct Params {
  // calcrmks: R0 + exp(x1 + cpow2 (x1 - xbr)^npow2 above xbr)
  T R0, xbr, cpow2, npow2;
  // ftrgen(|x2|, fracdisk, 1 - fracjet, 0, 1): the band's reciprocal width
  T fracdisk, inv_band;
  // mins(r / r0, 1, 0.5) (r0 / r0grid) and mins(r2, dr, 0.5 dr) for the
  // disk and the jet: 1 / r0, r0 / r0grid, r0grid, dr, 0.5 dr,
  // 1 / (0.5 dr), and the powers 0.5 nu1, 0.5 nu2
  T inv_r0disk, r0disk_grid, r0grid, drdisk, hdrdisk, inv_hdrdisk, e1disk,
      e2disk;
  T inv_r0jet, r0jet_grid, drjet, hdrjet, inv_hdrjet, e1jet, e2jet;
};
constexpr int kNumParams = sizeof(Params<double>) / sizeof(double);
static_assert(sizeof(Params<float>) == kNumParams * sizeof(float),
              "Params holds only scalars of T");

// torch's pow(tensor, Python float) on the card: its special cases, then
// pow
template <typename T>
__device__ __forceinline__ T torch_pow(T x, T e) {
  if (e == T(0)) return T(1);
  if (e == T(1)) return x;
  if (e == T(0.5)) return ::sqrt(x);
  if (e == T(-0.5)) return ::rsqrt(x);
  if (e == T(-1)) return T(1) / x;
  if (e == T(2)) return x * x;
  if (e == T(3)) return x * x * x;
  if (e == T(-2)) return T(1) / (x * x);
  return ::pow(x, e);
}

// fangle's where(x < -1, 0, where(x > 1, x, mid)); on the middle branch
// clamp(x, -1, 1) is x (a NaN goes through, as torch's clamp lets it)
template <typename T>
__device__ __forceinline__ T fangle(T x) {
  constexpr T kInv64Pi = T(1.0 / (64.0 * kPi));  // / (64 pi), a reciprocal
  if (x < T(-1)) return T(0);
  if (x > T(1)) return x;
  const T u = x + T(1);
  const T s1 = ::sin(u * T(kPi) * T(0.5)) * T(-140);
  const T s3 = ::sin(u * T(3.0 * kPi) * T(0.5)) * T(10.0 / 3.0);
  const T s5 = ::sin(u * T(5.0 * kPi) * T(0.5)) * T(0.4);
  return (u + (s1 + s3 + s5) * kInv64Pi) * T(0.5);
}

// mins(f1, f2, df) = f2 - df fangle(-(f1 - f2) / df), inv_df = 1 / df
template <typename T>
__device__ __forceinline__ T mins(T f1, T f2, T df, T inv_df) {
  return f2 - fangle(-(f1 - f2) * inv_df) * df;
}

// ftr's where(x <= 0, 0, where(x >= 1, 1, mid))
template <typename T>
__device__ __forceinline__ T ftr(T x) {
  if (x <= T(0)) return T(0);
  if (x >= T(1)) return T(1);
  const T v = x * T(2) - T(1);
  const T a = ::cos(x * T(5.0 * kPi)) + T(64);
  const T b = a + ::sin(v * T(kPi) * T(0.5)) * T(70);
  return (b + ::sin(v * T(3.0 * kPi) * T(0.5)) * T(5)) * T(1.0 / 128.0);
}

// ror0nu of the disk or the jet from r: r1 = mins(r / r0, 1, 0.5)
// (r0 / r0grid), r2 = mins(r / (r1 r0grid), dr, 0.5 dr), r1^e1 r2^e2
template <typename T>
__device__ __forceinline__ T ror0nu(T r, T inv_r0, T r0_grid, T r0grid,
                                    T dr, T hdr, T inv_hdr, T e1, T e2) {
  const T r1 = mins(r * inv_r0, T(1), T(0.5), T(2)) * r0_grid;
  const T r2 = mins(r / (r1 * r0grid), dr, hdr, inv_hdr);
  return torch_pow(r1, e1) * torch_pow(r2, e2);
}

// thetaofx2's selected branch, given its tangent t
template <typename T>
__device__ __forceinline__ T theta_branch(int branch, T t, T q) {
  if (branch == 0) return ::atan(t / q);
  if (branch == 1) return ::atan(t / q) + T(kPi);
  return ::atan(t * q) + T(kPi * 0.5);
}

template <typename T>
__device__ __forceinline__ bool finite_nonzero(T q) {
  return isfinite(q) && q != T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    x1_of_r(const T* __restrict__ r, T* __restrict__ x1, long long n,
            Params<T> p, T lo0, T hi0, int iters) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (i >= n) return;
  const T target = r[i];
  T lo = lo0, hi = hi0;
  for (int k = 0; k < iters; ++k) {
    const T mid = (lo + hi) * T(0.5);
    // above xbr, mid - xbr > 0: the twin's clamp_min(0) changes nothing
    const T xi =
        mid > p.xbr ? mid + torch_pow(mid - p.xbr, p.npow2) * p.cpow2 : mid;
    const bool big = ::exp(xi) + p.R0 > target;
    const bool last = mid == lo || mid == hi;
    if (big)
      hi = mid;
    else
      lo = mid;
    if (last) break;
  }
  x1[i] = (lo + hi) * T(0.5);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    x2_of_th(const T* __restrict__ th, const T* __restrict__ r,
             T* __restrict__ x2, long long n, Params<T> p, int iters) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (i >= n) return;
  const T target = th[i];
  const T ri = r[i];
  const T qdisk = ror0nu(ri, p.inv_r0disk, p.r0disk_grid, p.r0grid,
                         p.drdisk, p.hdrdisk, p.inv_hdrdisk, p.e1disk,
                         p.e2disk);
  const T qjet = ror0nu(ri, p.inv_r0jet, p.r0jet_grid, p.r0grid, p.drjet,
                        p.hdrjet, p.inv_hdrjet, p.e1jet, p.e2jet);
  // whether the side that fac weights by 0 may be left out (see above)
  const bool skip_jet = finite_nonzero(qjet);
  const bool skip_disk = finite_nonzero(qdisk);
  T lo = T(-1), hi = T(1);
  for (int k = 0; k < iters; ++k) {
    const T mid = (lo + hi) * T(0.5);
    const T fac = T(0) + ftr((::fabs(mid) - p.fracdisk) * p.inv_band) * T(1);
    // thetaofx2's where(x2 < -0.5, th1, where(x2 > 0.5, th2, th3))
    const int branch = mid < T(-0.5) ? 0 : (mid > T(0.5) ? 1 : 2);
    const T t = branch == 0   ? ::tan((mid + T(1)) * T(kPi) * T(0.5))
                : branch == 1 ? ::tan((mid - T(1)) * T(kPi) * T(0.5))
                              : ::tan(mid * T(kPi) * T(0.5));
    T f;
    if (fac == T(0) && skip_jet) {
      f = theta_branch(branch, t, qdisk);
    } else if (fac == T(1) && skip_disk) {
      f = theta_branch(branch, t, qjet);
    } else {
      const T tjet = theta_branch(branch, t, qjet);
      const T tdisk = theta_branch(branch, t, qdisk);
      f = fac * tjet + (T(1) - fac) * tdisk;
    }
    const bool big = f > target;
    const bool last = mid == lo || mid == hi;
    if (big)
      hi = mid;
    else
      lo = mid;
    if (last) break;
  }
  x2[i] = (lo + hi) * T(0.5);
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

template <typename T>
Params<T> load(const T* params) {
  Params<T> p;
  T* dst = reinterpret_cast<T*>(&p);
  for (int k = 0; k < kNumParams; ++k) dst[k] = params[k];
  return p;
}

template <typename T>
int launch_x1(const T* r, T* x1, long long n, const T* params, T lo, T hi,
              int iters, void* stream) {
  if (n < 0 || iters < 0 || params == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0)
    x1_of_r<T><<<blocks_for(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(r, x1, n, load(params),
                                                      lo, hi, iters);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_x2(const T* th, const T* r, T* x2, long long n, const T* params,
              int iters, void* stream) {
  if (n < 0 || iters < 0 || params == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0)
    x2_of_th<T><<<blocks_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(th, r, x2, n,
                                                       load(params), iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int harmpi_invert_num_params() { return kNumParams; }

extern "C" int harmpi_x1_of_r_f64(const double* r, double* x1, long long n,
                                  const double* params, double lo, double hi,
                                  int iters, void* stream) {
  return launch_x1(r, x1, n, params, lo, hi, iters, stream);
}

extern "C" int harmpi_x1_of_r_f32(const float* r, float* x1, long long n,
                                  const float* params, float lo, float hi,
                                  int iters, void* stream) {
  return launch_x1(r, x1, n, params, lo, hi, iters, stream);
}

extern "C" int harmpi_x2_of_th_f64(const double* th, const double* r,
                                   double* x2, long long n,
                                   const double* params, int iters,
                                   void* stream) {
  return launch_x2(th, r, x2, n, params, iters, stream);
}

extern "C" int harmpi_x2_of_th_f32(const float* th, const float* r,
                                   float* x2, long long n,
                                   const float* params, int iters,
                                   void* stream) {
  return launch_x2(th, r, x2, n, params, iters, stream);
}
