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
// What bounds it: the bytes it must move (index, weights and output once
// through device memory) set the floor, but with scattered rows the time
// goes to the row traffic out of L2 and to the instructions that fetch it,
// not to device memory.  The TPU kernel pinned the table in VMEM; on
// Hopper the FFJET table (16384 x 36) is 4.7 MB in float64 and 2.4 MB in
// float32, far above the 227 KB of shared memory a block can use, but it
// sits easily in the 50 MB L2, so rows are read straight through L2/L1.
//
// Two kernels:
//  * quad_gather_tiled<T, NC, NF>, for the two shapes the renderer uses,
//    (NC, NF) = (4, 9) and (2, 6).  A block of 128 threads takes a tile of
//    128 queries.  Each thread reads its own query's index and weights
//    once (16-byte loads).  The block then fetches the 128 rows as one
//    stream of 16-byte pieces, neighbouring threads on neighbouring
//    pieces of a row, so a warp's load covers whole rows instead of 32
//    scattered sectors, and every thread has all its row pieces (18 for a
//    float64 FFJET row) in flight before the first is used.  The rows are
//    laid into shared memory at an odd stride, each thread combines its
//    own query from there (corners summed in the order c = 0..NC-1), and
//    the tile's outputs go back through shared memory so that they leave
//    in 16-byte stores on consecutive addresses.  No run-time divide.
//  * quad_gather_generic<T>, for any other (nc, nf) or for operands that
//    are not 16-byte aligned: one thread per output element.
//
// Ragged edges are masked here (no padding to a block multiple).  An
// index outside [0, ns) sets *err and writes NaN instead of reading out
// of bounds; the host reads the flag after a run.
//
// C interface (ctypes): quad_gather_f32 / quad_gather_f64 launch on the
// given stream and return cudaGetLastError().  `variant` 0 picks the
// kernel by shape, 1 forces the generic kernel (used to time one against
// the other).

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

// 16-byte vector of T and its lanes.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using type = float4;
};
template <> struct Vec16<double> {
  using type = double2;
};
__device__ __forceinline__ void unpack(const float4& v, float* a) {
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}
__device__ __forceinline__ void unpack(const double2& v, double* a) {
  a[0] = v.x;
  a[1] = v.y;
}
__device__ __forceinline__ float4 pack(const float* a) {
  return make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ double2 pack(const double* a) {
  return make_double2(a[0], a[1]);
}

template <typename T>
__global__ void quad_gather_generic(const T* __restrict__ table,
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

constexpr int kTile = 128;  // queries, and threads, per block

template <typename T, int NC, int NF>
__global__ void __launch_bounds__(kTile)
quad_gather_tiled(const T* __restrict__ table,
                  const int32_t* __restrict__ idx,
                  const T* __restrict__ w, T* __restrict__ out,
                  int* __restrict__ err, long long n, int ns) {
  using V = typename Vec16<T>::type;
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte piece
  constexpr int ROW = NC * NF;          // elements per table row
  static_assert(ROW % VEC == 0, "rows must be whole 16-byte pieces");
  constexpr int RV = ROW / VEC;         // pieces per row, and per thread
  constexpr int STRIDE = ROW | 1;       // odd: no bank conflict on reads
  static_assert(kTile * NF <= kTile * STRIDE, "output stage fits");

  __shared__ int s_row[kTile];
  __shared__ __align__(16) T s_buf[kTile * STRIDE];

  const int t = threadIdx.x;
  const long long q0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long left = n - q0;
  const int nq = left < kTile ? static_cast<int>(left) : kTile;

  // 1. this thread's query: index and weights, read once
  int row = -1;
  bool bad = false;
  T wq[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) wq[c] = T(0);
  if (t < nq) {
    row = __ldg(idx + q0 + t);
    if (row < 0 || row >= ns) {
      bad = true;
      row = -1;
      atomicExch(err, 1);
    }
    const T* wp = w + (q0 + t) * NC;
    if constexpr (NC % VEC == 0) {
#pragma unroll
      for (int i = 0; i < NC / VEC; ++i)
        unpack(__ldg(reinterpret_cast<const V*>(wp) + i), wq + i * VEC);
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) wq[c] = __ldg(wp + c);
    }
  }
  s_row[t] = row;
  __syncthreads();

  // 2. the tile's rows as one stream of 16-byte pieces: piece k belongs
  //    to query k / RV; all RV loads are issued before any is stored
  V regs[RV];
#pragma unroll
  for (int i = 0; i < RV; ++i) {
    const int k = i * kTile + t;
    const int qq = k / RV;
    const int piece = k - qq * RV;
    const int r = s_row[qq];
    T zero[VEC] = {};
    regs[i] = r >= 0
        ? __ldg(reinterpret_cast<const V*>(
                    table + static_cast<long long>(r) * ROW) + piece)
        : pack(zero);
  }
#pragma unroll
  for (int i = 0; i < RV; ++i) {
    const int k = i * kTile + t;
    const int qq = k / RV;
    const int piece = k - qq * RV;
    T lanes[VEC];
    unpack(regs[i], lanes);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      s_buf[qq * STRIDE + piece * VEC + e] = lanes[e];
  }
  __syncthreads();

  // 3. combine this thread's query, corners in the order c = 0..NC-1
  T acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    T a = T(0);
#pragma unroll
    for (int c = 0; c < NC; ++c) a += wq[c] * s_buf[t * STRIDE + c * NF + f];
    acc[f] = bad ? quiet_nan<T>() : a;
  }
  __syncthreads();

  // 4. outputs through shared memory, then 16-byte stores in order
#pragma unroll
  for (int f = 0; f < NF; ++f) s_buf[t * NF + f] = acc[f];
  __syncthreads();
  const int total = nq * NF;
  T* o = out + q0 * NF;
  const int nvec = total / VEC;
  for (int k = t; k < nvec; k += kTile)
    reinterpret_cast<V*>(o)[k] = *reinterpret_cast<const V*>(s_buf + k * VEC);
  for (int k = nvec * VEC + t; k < total; k += kTile) o[k] = s_buf[k];
}

template <typename T, int NC, int NF>
void launch_tiled(const T* table, const int32_t* idx, const T* w, T* out,
                  int* err, long long n, int ns, cudaStream_t stream) {
  const long long blocks = (n + kTile - 1) / kTile;
  quad_gather_tiled<T, NC, NF>
      <<<static_cast<unsigned int>(blocks), kTile, 0, stream>>>(
          table, idx, w, out, err, n, ns);
}

template <typename T>
int launch(const T* table, const int32_t* idx, const T* w, T* out, int* err,
           long long n, int ns, int nc, int nf, int variant, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (n > 0) {
    if (variant == 0 && nc == 4 && nf == 9) {
      launch_tiled<T, 4, 9>(table, idx, w, out, err, n, ns, stream);
    } else if (variant == 0 && nc == 2 && nf == 6) {
      launch_tiled<T, 2, 6>(table, idx, w, out, err, n, ns, stream);
    } else {
      constexpr int kThreads = 256;
      const long long total = n * nf;
      const long long blocks = (total + kThreads - 1) / kThreads;
      quad_gather_generic<T>
          <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
              table, idx, w, out, err, n, ns, nc, nf);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int quad_gather_f32(const float* table, const int32_t* idx,
                               const float* w, float* out, int* err,
                               long long n, int ns, int nc, int nf,
                               int variant, void* stream) {
  return launch<float>(table, idx, w, out, err, n, ns, nc, nf, variant,
                       stream);
}

extern "C" int quad_gather_f64(const double* table, const int32_t* idx,
                               const double* w, double* out, int* err,
                               long long n, int ns, int nc, int nf,
                               int variant, void* stream) {
  return launch<double>(table, idx, w, out, err, n, ns, nc, nf, variant,
                        stream);
}
