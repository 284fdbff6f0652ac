// The sequential IIR recurrence (S1): direct form II transposed over rows.
//
// A port kernel with no Pallas counterpart.  It replaces the JAX package's
// _sequential_filter (waveforms_tpu/ops/iir.py), a lax.scan that lfilter
// and sosfilt take where the doubling scan is numerically unstable
// (clustered near-unit poles, defective sections).  PyTorch has no scan, and
// a scan in plain torch on the card would be a Python loop of several
// launches per sample.  Each row x[r, :] is filtered by
//
//   y[i]   = b0 x[i] + s[0]
//   s'[j]  = (s[j+1] + b[j+1] x[i]) - a[j+1] y[i]     (s[d] = 0)
//
// from the state zi[r, :] (d entries), and the state after the last sample
// goes to zf[r, :]: scipy's lfilter zi/zf semantics, in the signal's type
// (float64, or float32 for an f32 signal), in the order of operations of
// the JAX step and of the plain version (ops/reference_iir.py).
//
// FMA contraction: nvcc would contract b0*x + s into one fused
// multiply-add, which scipy's loop, the JAX scan and the plain version do
// not.  The clustered-pole filters amplify their state by ~1e10, so one
// contraction a step moves the output at 1e-6.  Every product and sum of
// the step is therefore written with the round-to-nearest intrinsics
// (__dmul_rn, __dadd_rn, __dsub_rn and their f32 twins), which nvcc never
// contracts; the source needs no -fmad=false.
//
// Layout: one thread walks one row's n samples, with its d-dimensional
// state (d <= IIR_MAX_D, a template parameter) in registers.  A thread
// block holds IIR_ROWS rows: warp 0 computes, one lane a row, and
// IIR_MEM_WARPS memory warps move the rows through shared memory in tiles
// of IIR_T samples, coalesced: while warp 0 filters tile p in place, they
// store tile p - 1's outputs and load tile p + 1 with asynchronous copies
// (three buffers, one __syncthreads a tile).  Rows are padded one word so
// that warp 0's lanes, IIR_T + 1 words apart, hit distinct banks.  Every
// thread reads the coefficients and a state into its registers, the walkers
// and the memory warps alike: an array initialised under a condition let
// ptxas keep b[0] in a stack slot that another value shared (wrong outputs
// for f64 at d >= 3 in a first build).
//
// What bounds it on the H100: the recurrence itself.  Each sample's state
// depends on the last sample's output through a dependent add, multiply and
// subtract, ~3 FP64 latencies a sample, so a row of n samples takes ~n of
// those chains whatever the card's width; the byte bound (each sample read
// and written once) is far below that.  Rows run in parallel, one a lane.
// A blocked parallel-in-time scan is the lever for a later change.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace wfiir {

constexpr int IIR_ROWS = 16;        // rows per thread block (lanes of warp 0)
constexpr int IIR_T = 256;          // samples per tile
constexpr int IIR_PAD = IIR_T + 1;  // words per staged row
constexpr int IIR_MEM_WARPS = 3;    // warps that load and store
constexpr int IIR_THREADS = 32 * (1 + IIR_MEM_WARPS);
constexpr int IIR_BUFS = 3;         // computed, stored, loaded
constexpr int IIR_MAX_D = 16;       // the largest state
static_assert(IIR_ROWS <= 32, "one row a lane of warp 0");

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}

// Tile p of rows [r0, r0 + nr) from x into a staging buffer, by the memory
// warps' IIR_MEM_WARPS * 32 threads, as asynchronous copies (cp.async): each
// thread issues all its copies and then waits once, so a tile costs about
// one load latency, where a load-then-store loop would wait once a sample.
template <typename T>
__device__ __forceinline__ void load_tile(const T* x, T* buf, int r0, int nr,
                                          long long n, long long p) {
  const long long col0 = p * IIR_T;
  const int len = (int)min((long long)IIR_T, n - col0);
  for (int e = threadIdx.x - 32; e < nr * IIR_T; e += 32 * IIR_MEM_WARPS) {
    const int r = e / IIR_T, c = e - r * IIR_T;
    if (c < len)
      __pipeline_memcpy_async(&buf[r * IIR_PAD + c],
                              &x[(long long)(r0 + r) * n + col0 + c],
                              sizeof(T));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// Tile p's outputs from the staging buffer to y, by the memory warps.
template <typename T>
__device__ __forceinline__ void store_tile(T* y, const T* buf, int r0, int nr,
                                           long long n, long long p) {
  const long long col0 = p * IIR_T;
  const int len = (int)min((long long)IIR_T, n - col0);
#pragma unroll 4
  for (int e = threadIdx.x - 32; e < nr * IIR_T; e += 32 * IIR_MEM_WARPS) {
    const int r = e / IIR_T, c = e - r * IIR_T;
    if (c < len) y[(long long)(r0 + r) * n + col0 + c] = buf[r * IIR_PAD + c];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(IIR_THREADS)
iir_df2t_kernel(const T* __restrict__ x, const T* __restrict__ coef,
                const T* __restrict__ zi, T* __restrict__ y,
                T* __restrict__ zf, int rows, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);  // [IIR_BUFS][IIR_ROWS][IIR_PAD]
  const int r0 = blockIdx.x * IIR_ROWS;
  const int nr = min(IIR_ROWS, rows - r0);
  const long long n_tiles = (n + IIR_T - 1) / IIR_T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool walker = warp == 0 && lane < nr;

  // the coefficients and the state in registers, read by every thread
  // (a lane past the last row reads that row's state and never walks)
  T b[D + 1], a[D], s[D];
  const long long zrow = (long long)min(r0 + lane, rows - 1) * D;
#pragma unroll
  for (int j = 0; j <= D; ++j) b[j] = coef[j];
#pragma unroll
  for (int j = 0; j < D; ++j) a[j] = coef[D + 2 + j];   // a[1..D]
#pragma unroll
  for (int j = 0; j < D; ++j) s[j] = zi[zrow + j];

  if (warp > 0 && n_tiles > 0) load_tile(x, stage, r0, nr, n, 0);
  __syncthreads();
  for (long long p = 0; p <= n_tiles; ++p) {
    if (warp == 0) {
      if (walker && p < n_tiles) {
        T* row = stage + ((int)(p % IIR_BUFS) * IIR_ROWS + lane) * IIR_PAD;
        const int len = (int)min((long long)IIR_T, n - p * IIR_T);
#pragma unroll 4
        for (int i = 0; i < len; ++i) {
          const T xn = row[i];
          const T yn = add_rn(mul_rn(b[0], xn), s[0]);
#pragma unroll
          for (int j = 0; j < D - 1; ++j)
            s[j] = sub_rn(add_rn(s[j + 1], mul_rn(b[j + 1], xn)),
                          mul_rn(a[j], yn));
          s[D - 1] = sub_rn(add_rn(T(0), mul_rn(b[D], xn)),
                            mul_rn(a[D - 1], yn));
          row[i] = yn;
        }
      }
    } else {
      if (p >= 1)
        store_tile(y, stage + (int)((p - 1) % IIR_BUFS) * IIR_ROWS * IIR_PAD,
                   r0, nr, n, p - 1);
      if (p + 1 < n_tiles)
        load_tile(x, stage + (int)((p + 1) % IIR_BUFS) * IIR_ROWS * IIR_PAD,
                  r0, nr, n, p + 1);
    }
    __syncthreads();
  }
  if (walker) {
#pragma unroll
    for (int j = 0; j < D; ++j) zf[(long long)(r0 + lane) * D + j] = s[j];
  }
}

// the dynamic shared memory of one thread block: the staged tiles
template <typename T>
constexpr int smem_bytes() {
  return IIR_BUFS * IIR_ROWS * IIR_PAD * (int)sizeof(T);
}

template <typename T, int D>
static int launch(const void* x, const void* coef, const void* zi, void* y,
                  void* zf, int rows, long long n, cudaStream_t st) {
  const int smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      iir_df2t_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  if (rows > 0) {
    const int blocks = (rows + IIR_ROWS - 1) / IIR_ROWS;
    iir_df2t_kernel<T, D><<<blocks, IIR_THREADS, smem, st>>>(
        (const T*)x, (const T*)coef, (const T*)zi, (T*)y, (T*)zf, rows, n);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(int d, const void* x, const void* coef, const void* zi,
                    void* y, void* zf, int rows, long long n,
                    cudaStream_t st) {
  switch (d) {
#define WF_IIR_CASE(D) \
  case D:              \
    return launch<T, D>(x, coef, zi, y, zf, rows, n, st);
    WF_IIR_CASE(1) WF_IIR_CASE(2) WF_IIR_CASE(3) WF_IIR_CASE(4)
    WF_IIR_CASE(5) WF_IIR_CASE(6) WF_IIR_CASE(7) WF_IIR_CASE(8)
    WF_IIR_CASE(9) WF_IIR_CASE(10) WF_IIR_CASE(11) WF_IIR_CASE(12)
    WF_IIR_CASE(13) WF_IIR_CASE(14) WF_IIR_CASE(15) WF_IIR_CASE(16)
#undef WF_IIR_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wfiir

extern "C" {

// Filter `rows` rows of n samples (x, y: (rows, n); zi, zf: (rows, d);
// coef: (2 * (d + 1),) = b[0..d] then a[0..d], a[0] = 1) on `stream`;
// `dtype` 0 is float64, 1 float32, for every pointer.  Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a state
// of more than IIR_MAX_D (or fewer than 1) entries or another dtype.
int wf_iir_df2t(const void* x, const void* coef, const void* zi, void* y,
                void* zf, int rows, long long n, int d, int dtype,
                void* stream) {
  if (d < 1 || d > wfiir::IIR_MAX_D || rows < 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return wfiir::dispatch<double>(d, x, coef, zi, y, zf, rows, n, st);
  if (dtype == 1)
    return wfiir::dispatch<float>(d, x, coef, zi, y, zf, rows, n, st);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory bytes wf_iir_df2t gives each thread block for
// `dtype` (0 float64, 1 float32), or -1 for another dtype.
int wf_iir_df2t_smem_bytes(int dtype) {
  if (dtype == 0) return wfiir::smem_bytes<double>();
  if (dtype == 1) return wfiir::smem_bytes<float>();
  return -1;
}

}  // extern "C"
