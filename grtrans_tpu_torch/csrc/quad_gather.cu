// Fused packed-row gather + corner combine for Hopper (sm_90a).
//
//   out[n, f] = sum_{c < nc} w[n, c] * table[idx[n], c * nf + f]
//
// Replaces the Pallas TPU kernel grtrans_tpu/ops/pallas_gather.py
// (vmem_row_gather, the pallas_call at :49) together with its XLA
// epilogue quad_combine (:64), in one pass.  Callers: FFJet.vals (4
// corners x 9 fields of the bilinear sampler) and polsynchpl._g_all
// (2 bracketing rows x 6 cutoff tables).
//
// What bounds it: every output element costs one dependent load chain
// (idx -> table row) and a handful of FMAs, so the kernel is bound by
// gather latency, not by bandwidth or arithmetic.  The TPU kernel pinned
// the table in VMEM; on Hopper the FFJET table (16384 x 36) is 4.7 MB in
// float64 and 2.4 MB in float32, far above the 227 KB of shared memory a
// block can use, but it sits easily in the 50 MB L2, so rows are read
// straight through L2 (__ldg).  One thread per output element: the nf
// threads of one query read neighbouring addresses of one row, and the
// query index and weights are broadcast within the warp.
//
// Ragged edges are masked here (no padding to a block multiple).  An
// index outside [0, ns) sets *err and writes NaN instead of reading out
// of bounds; the host reads the flag after a run.
//
// C interface (ctypes): quad_gather_f32 / quad_gather_f64 launch on the
// given stream and return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

template <typename T> __device__ __forceinline__ T quiet_nan();
template <> __device__ __forceinline__ float quiet_nan<float>() {
  return CUDART_NAN_F;
}
template <> __device__ __forceinline__ double quiet_nan<double>() {
  return CUDART_NAN;
}

template <typename T>
__global__ void quad_gather_kernel(const T* __restrict__ table,
                                   const int32_t* __restrict__ idx,
                                   const T* __restrict__ w,
                                   T* __restrict__ out,
                                   int* __restrict__ err,
                                   long long n, int ns, int nc, int nf) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n * nf) return;
  const long long q = t / nf;
  const int f = static_cast<int>(t - q * nf);
  const int row = __ldg(idx + q);
  if (row < 0 || row >= ns) {
    atomicExch(err, 1);
    out[t] = quiet_nan<T>();
    return;
  }
  const T* trow = table + static_cast<long long>(row) * nc * nf + f;
  const T* wq = w + q * nc;
  T acc = T(0);
  for (int c = 0; c < nc; ++c) acc += __ldg(wq + c) * __ldg(trow + c * nf);
  out[t] = acc;
}

template <typename T>
int launch(const T* table, const int32_t* idx, const T* w, T* out, int* err,
           long long n, int ns, int nc, int nf, void* stream) {
  constexpr int kThreads = 256;
  const long long total = n * nf;
  if (total > 0) {
    const long long blocks = (total + kThreads - 1) / kThreads;
    quad_gather_kernel<T>
        <<<static_cast<unsigned int>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(table, idx, w, out, err, n,
                                                 ns, nc, nf);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int quad_gather_f32(const float* table, const int32_t* idx,
                               const float* w, float* out, int* err,
                               long long n, int ns, int nc, int nf,
                               void* stream) {
  return launch<float>(table, idx, w, out, err, n, ns, nc, nf, stream);
}

extern "C" int quad_gather_f64(const double* table, const int32_t* idx,
                               const double* w, double* out, int* err,
                               long long n, int ns, int nc, int nf,
                               void* stream) {
  return launch<double>(table, idx, w, out, err, n, ns, nc, nf, stream);
}
