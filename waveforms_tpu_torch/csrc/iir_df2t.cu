// The IIR recurrence (S1): direct form II transposed over rows, as a blocked
// parallel-in-time scan.
//
// A port kernel with no Pallas counterpart.  It replaces the JAX package's
// _sequential_filter (waveforms_tpu/ops/iir.py), a lax.scan that lfilter
// and sosfilt take where the doubling scan is numerically unstable
// (clustered near-unit poles, defective sections).  Each row x[r, :] is
// filtered by
//
//   y[i]   = b0 x[i] + s[0]
//   s'[j]  = (s[j+1] + b[j+1] x[i]) - a[j+1] y[i]     (s[d] = 0)
//
// from the state zi[r, :] (d entries); the state after the last sample goes
// to zf[r, :]: scipy's lfilter zi/zf semantics, float64 or float32.
//
// What bounds it: a row walked in time order waits on a dependent add,
// multiply and subtract a sample (~22 ns), whatever the card's width.  So
// each row is cut into K chunks of IIR_L samples and scanned in parallel
// (the recurrence is linear in the state and the input), in three phases:
//
//   A. iir_chunk_ends_kernel: one thread a chunk (but the row's last) runs
//      the recurrence from a zero state and keeps its end state e[k]; its
//      block 0 computes Phi = A^L, the L-step zero-input map of the state,
//      from L steps from each unit state (never by squaring: powers of
//      these companion matrices squared up lose their digits);
//   B. the carry, s_0 = zi, s_k = Phi s_{k-1} + e[k-1], each chunk's start
//      state S[k] rounded to the signal's type: in two levels of groups of
//      IIR_B_GROUP steps, three launches (see "B" below);
//   C. iir_output_kernel: one thread a chunk runs the recurrence in the
//      signal's type from S[k] (chunk 0 from zi), in the operations of the
//      plain sequential version, and writes y; the row's last chunk writes
//      zf, consistent with y.
//
// The state-only call (y null: the end state of each row and nothing else,
// as a time-sharded filter's carry across shards asks) runs A and B, then
// in place of C iir_final_state_kernel: one thread a row walks only the
// row's last chunk from S[K-1], in C's operations, and writes zf, equal to
// the full call's bit for bit.
//
// What bounds the phases: A by FP64 throughput (a double-double step is ~149
// FP64 instructions a sample at d = 3), C by memory (x read, y written), B
// by its dependent chain of double-double products and sums, which its
// two levels keep to 2 IIR_B_GROUP + G - 1 steps a row.  x is read twice
// (A and C), so the design's byte floor is 1.5x the function's.
//
// Precision: the clustered-pole filters amplify their state's rounding by
// ~1e10, and the carry's error grows with Phi's entries (2.5e5 at L = 512),
// so for a float64 signal A and B run in double-double (Dekker pairs, ~106
// bits); for a float32 signal in plain float64.  The blocked output is then
// closer to the exact answer than the sequential recurrence, and bit-equal
// to it over each row's first chunk; ops/reference_iir.df2t_blocked models
// it operation for operation.
//
// FMA contraction: every product and sum is written with the
// round-to-nearest intrinsics (__dmul_rn, __dadd_rn, __dsub_rn and their
// f32 twins), which nvcc never contracts: a contracted TwoSum is wrong, and
// one contraction a step of the output pass moves a clustered filter's
// output at 1e-6.  TwoProd's exact error term is the one __fma_rn.
//
// Layout of A and C: a thread block takes IIR_W consecutive chunks of one
// row, one a lane of its IIR_CWARPS compute warps; IIR_MEM_WARPS memory
// warps stage them through shared memory in tiles of 256 bytes of each
// chunk (iir_tile<T>() samples), coalesced: while the compute warps walk
// tile p in place, they store tile p - 1's outputs (C) and load tile p + 1
// with asynchronous copies (three buffers, one __syncthreads a tile).  A
// chunk's staged row is padded one word so that the compute lanes, a row
// apart, hit distinct banks.  Every thread reads the coefficients and a
// state into its registers, the compute and the memory warps alike: an
// array initialised under a condition let ptxas keep b[0] in a stack slot
// that another value shared (wrong outputs for f64 at d >= 3 in the first
// sequential build).  A row of n <= IIR_L samples is one chunk: A and B do
// not run and C is the sequential walk.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

namespace wfiir {

constexpr int IIR_L = 512;           // samples a chunk (reference_iir.CHUNK)
constexpr int IIR_CWARPS = 2;        // compute warps: one chunk a lane
constexpr int IIR_W = 32 * IIR_CWARPS;   // chunks a thread block (A, C)
constexpr int IIR_MEM_WARPS = 2;     // warps that load and store
constexpr int IIR_THREADS = 32 * (IIR_CWARPS + IIR_MEM_WARPS);
constexpr int IIR_BUFS = 3;          // computed, stored, loaded
constexpr int IIR_B_THREADS = 128;   // threads a block of the carry
constexpr int IIR_B_AHEAD = 4;       // steps of the carry its loads lead by
constexpr int IIR_B_GROUP = 32;      // steps a group of the carry
                                     // (reference_iir.CARRY_GROUP)
constexpr int IIR_MAX_D = 16;        // the largest state

// samples a staged tile of one chunk: 256 bytes
template <typename T>
__host__ __device__ constexpr int iir_tile() {
  return 256 / (int)sizeof(T);
}
static_assert(IIR_L % iir_tile<float>() == 0, "whole tiles a chunk");

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

// ---- double-double (hi, lo), in reference_iir's order of operations ----

struct dd {
  double hi, lo;
};

__device__ __forceinline__ dd two_sum(double a, double b) {
  const double s = __dadd_rn(a, b);
  const double bb = __dsub_rn(s, a);
  return {s, __dadd_rn(__dsub_rn(a, __dsub_rn(s, bb)), __dsub_rn(b, bb))};
}

__device__ __forceinline__ dd fast_two_sum(double a, double b) {
  const double s = __dadd_rn(a, b);
  return {s, __dsub_rn(b, __dsub_rn(s, a))};
}

__device__ __forceinline__ dd two_prod(double a, double b) {
  const double p = __dmul_rn(a, b);
  return {p, __fma_rn(a, b, -p)};
}

__device__ __forceinline__ dd dd_add(dd x, dd y) {
  const dd s = two_sum(x.hi, y.hi);
  const dd t = two_sum(x.lo, y.lo);
  const dd u = fast_two_sum(s.hi, __dadd_rn(s.lo, t.hi));
  return fast_two_sum(u.hi, __dadd_rn(u.lo, t.lo));
}

__device__ __forceinline__ dd dd_sub(dd x, dd y) {
  return dd_add(x, dd{-y.hi, -y.lo});
}

__device__ __forceinline__ dd dd_mul_d(dd x, double c) {
  const dd p = two_prod(x.hi, c);
  return fast_two_sum(p.hi, __dadd_rn(p.lo, __dmul_rn(x.lo, c)));
}

__device__ __forceinline__ dd dd_mul(dd x, dd y) {
  const dd p = two_prod(x.hi, y.hi);
  return fast_two_sum(p.hi, __dadd_rn(p.lo, __dadd_rn(__dmul_rn(x.hi, y.lo),
                                                     __dmul_rn(x.lo, y.hi))));
}

// ---- one step of the recurrence ----

// in the signal's type (or plain float64 for a float32 signal's carry): the
// operations of the plain sequential version -> y
template <typename V, int D>
__device__ __forceinline__ V step(V (&s)[D], V xn, const V (&b)[D + 1],
                                  const V (&a)[D]) {
  const V yn = add_rn(mul_rn(b[0], xn), s[0]);
#pragma unroll
  for (int j = 0; j < D - 1; ++j)
    s[j] = sub_rn(add_rn(s[j + 1], mul_rn(b[j + 1], xn)), mul_rn(a[j], yn));
  s[D - 1] = sub_rn(add_rn(V(0), mul_rn(b[D], xn)), mul_rn(a[D - 1], yn));
  return yn;
}

// in double-double, the input and the coefficients float64
template <int D>
__device__ __forceinline__ void step(dd (&s)[D], double xn,
                                     const double (&b)[D + 1],
                                     const double (&a)[D]) {
  const dd yn = dd_add(two_prod(b[0], xn), s[0]);
#pragma unroll
  for (int j = 0; j < D - 1; ++j)
    s[j] = dd_sub(dd_add(s[j + 1], two_prod(b[j + 1], xn)),
                  dd_mul_d(yn, a[j]));
  s[D - 1] = dd_sub(two_prod(b[D], xn), dd_mul_d(yn, a[D - 1]));
}

// the carry's number: double-double for a float64 signal, float64 for f32
template <typename T>
using carry_t = std::conditional_t<std::is_same<T, double>::value, dd, double>;

__device__ __forceinline__ void zero(dd& v) { v = dd{0.0, 0.0}; }
__device__ __forceinline__ void zero(double& v) { v = 0.0; }
// a unit vector's entry, 1 or 0, set without a branch
__device__ __forceinline__ void basis(dd& v, bool one) {
  v = dd{one ? 1.0 : 0.0, 0.0};
}
__device__ __forceinline__ void basis(double& v, bool one) {
  v = one ? 1.0 : 0.0;
}
__device__ __forceinline__ dd from_signal(double v) { return dd{v, 0.0}; }
__device__ __forceinline__ double from_signal(float v) { return (double)v; }
__device__ __forceinline__ dd carry_add(dd a, dd b) { return dd_add(a, b); }
__device__ __forceinline__ double carry_add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ dd carry_mul(dd a, dd b) { return dd_mul(a, b); }
__device__ __forceinline__ double carry_mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ void store_signal(double* out, dd v) {
  *out = __dadd_rn(v.hi, v.lo);
}
__device__ __forceinline__ void store_signal(float* out, double v) {
  *out = __double2float_rn(v);
}
// e[k]'s (hi, lo) words
__device__ __forceinline__ void store_end(double* e, dd v) {
  e[0] = v.hi;
  e[1] = v.lo;
}
__device__ __forceinline__ void store_end(double* e, double v) {
  e[0] = v;
  e[1] = 0.0;
}
__device__ __forceinline__ void load_end(const double* e, dd& v) {
  v = dd{e[0], e[1]};
}
__device__ __forceinline__ void load_end(const double* e, double& v) {
  v = e[0];
}

// ---- staging: a block's chunks of one row, tile by tile ----

// Tile p of chunks [k0, k0 + nc) of row xr into a staging buffer, by the
// memory warps' IIR_MEM_WARPS * 32 threads, as asynchronous copies: each
// thread issues all its copies and then waits once, so a tile costs about
// one load latency.
template <typename T>
__device__ __forceinline__ void load_tile(const T* xr, T* buf, long long k0,
                                          int nc, long long n, int p) {
  constexpr int TT = iir_tile<T>();
  for (int e = threadIdx.x - 32 * IIR_CWARPS; e < nc * TT;
       e += 32 * IIR_MEM_WARPS) {
    const int c = e / TT, i = e - c * TT;
    const long long col = (k0 + c) * IIR_L + (long long)p * TT + i;
    if (col < n)
      __pipeline_memcpy_async(&buf[c * (TT + 1) + i], &xr[col], sizeof(T));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// Tile p's outputs from the staging buffer to row yr, by the memory warps.
template <typename T>
__device__ __forceinline__ void store_tile(T* yr, const T* buf, long long k0,
                                           int nc, long long n, int p) {
  constexpr int TT = iir_tile<T>();
#pragma unroll 4
  for (int e = threadIdx.x - 32 * IIR_CWARPS; e < nc * TT;
       e += 32 * IIR_MEM_WARPS) {
    const int c = e / TT, i = e - c * TT;
    const long long col = (k0 + c) * IIR_L + (long long)p * TT + i;
    if (col < n) yr[col] = buf[c * (TT + 1) + i];
  }
}

// samples of tile p of chunk k in a row of n
template <typename T>
__device__ __forceinline__ int tile_len(long long k, int p, long long n) {
  const long long left = n - k * IIR_L - (long long)p * iir_tile<T>();
  return (int)max(0LL, min((long long)iir_tile<T>(), left));
}

// the coefficients, in the carry's float64 and in the signal's type
template <typename T, typename V, int D>
__device__ __forceinline__ void load_coef(const T* coef, V (&b)[D + 1],
                                          V (&a)[D]) {
#pragma unroll
  for (int j = 0; j <= D; ++j) b[j] = (V)coef[j];
#pragma unroll
  for (int j = 0; j < D; ++j) a[j] = (V)coef[D + 2 + j];   // a[1..D]
}

// ---- A: each chunk's end state from a zero state ----

// Phi = A^L, column j from L zero-input steps from the unit state e_j, by
// threads 0..D-1 -> phi (D, D), row-major
template <typename T, int D>
__device__ __forceinline__ void carry_matrix(const double (&b)[D + 1],
                                             const double (&a)[D],
                                             carry_t<T>* phi) {
  if (threadIdx.x >= D) return;
  carry_t<T> u[D];
#pragma unroll
  for (int i = 0; i < D; ++i) basis(u[i], i == (int)threadIdx.x);
  for (int t = 0; t < IIR_L; ++t) step(u, 0.0, b, a);
#pragma unroll
  for (int i = 0; i < D; ++i) phi[i * D + threadIdx.x] = u[i];
}

// Block 0 computes Phi (the carry's matrix) while the others run the chunks:
// it takes the first wave, and its L sequential steps hide behind them.
template <typename T, int D>
__global__ void __launch_bounds__(IIR_THREADS)
iir_chunk_ends_kernel(const T* __restrict__ x, const T* __restrict__ coef,
                      double* __restrict__ ends, carry_t<T>* __restrict__ phi,
                      long long n, int K, int groups) {
  constexpr int TT = iir_tile<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);   // [IIR_BUFS][IIR_W][TT + 1]
  double b[D + 1], a[D];
  load_coef<T, double, D>(coef, b, a);
  if (blockIdx.x == 0) {
    carry_matrix<T, D>(b, a, phi);
    return;
  }
  const int blk = blockIdx.x - 1;
  const int r = blk / groups;
  const long long k0 = (long long)(blk - r * groups) * IIR_W;
  const int nc = (int)min((long long)IIR_W, (K - 1) - k0);   // not the last
  const int c = threadIdx.x;
  const bool walker = c < nc;
  const T* xr = x + (long long)r * n;

  carry_t<T> s[D];
#pragma unroll
  for (int j = 0; j < D; ++j) zero(s[j]);

  constexpr int P = IIR_L / TT;
  if (c >= IIR_W) load_tile(xr, stage, k0, nc, n, 0);
  __syncthreads();
  for (int p = 0; p < P; ++p) {
    if (c < IIR_W) {
      if (walker) {
        const T* row = stage + ((p % IIR_BUFS) * IIR_W + c) * (TT + 1);
#pragma unroll 4
        for (int i = 0; i < TT; ++i) step(s, (double)row[i], b, a);
      }
    } else if (p + 1 < P) {
      load_tile(xr, stage + ((p + 1) % IIR_BUFS) * IIR_W * (TT + 1), k0, nc,
                n, p + 1);
    }
    __syncthreads();
  }
  if (walker) {
    double* e = ends + (((long long)r * K + k0 + c) * D) * 2;
#pragma unroll
    for (int j = 0; j < D; ++j) store_end(e + 2 * j, s[j]);
  }
}

// ---- B: the carry along each row, in two levels ----
//
// s_0 = zi, s_k = Phi s_{k-1} + e[k-1] for the K - 1 steps k of a row, cut
// into G = ceil((K - 1) / M) groups of M = IIR_B_GROUP steps, the last
// shorter (a group does not depend on the row's length, so neither does a
// column on the samples after it):
//   B1. iir_group_ends_kernel: each group but the last from a zero state ->
//       its end F[g]; walkers past them compute Psi = Phi^M, M steps from
//       each unit state;
//   B2. iir_group_starts_kernel: each row walks the groups' starts
//       T_0 = zi, T_g = Psi T_{g-1} + F[g-1] (G - 1 steps);
//   B3. iir_chunk_starts_kernel: each group again from T_g, storing every
//       chunk's start state S[k] rounded to the signal's type.
// A row walks 2 M + G - 1 dependent steps where one walk took K - 1 (186
// for the flagship's 3907 chunks), each a chain of double-double products
// and sums.  A walker holds a state in
// carry_lanes<D>() lanes, lane i its entry i: a step's entry i is the
// pairwise sum of (add_i, Mat_i0 s_0, ..., Mat_i,D-1 s_{D-1}), adjacent
// terms first (ceil(log2(D + 1)) additions deep), the s_j from their lanes
// by shuffles, so that a step's D^2 products spread over D lanes.

// lanes a walker: D rounded up to a power of two
template <int D>
__host__ __device__ constexpr int carry_lanes() {
  return D <= 1 ? 1 : D <= 2 ? 2 : D <= 4 ? 4 : D <= 8 ? 8 : 16;
}

__device__ __forceinline__ dd shfl(dd v, int lane, int width) {
  return dd{__shfl_sync(0xffffffffu, v.hi, lane, width),
            __shfl_sync(0xffffffffu, v.lo, lane, width)};
}
__device__ __forceinline__ double shfl(double v, int lane, int width) {
  return __shfl_sync(0xffffffffu, v, lane, width);
}

// one step s <- m s + add in a walker's lane; m its row of the matrix
template <typename C, int D>
__device__ __forceinline__ C carry_step(C s, const C (&m)[D], C add) {
  C t[D + 1];
  t[0] = add;
#pragma unroll
  for (int j = 0; j < D; ++j)
    t[j + 1] = carry_mul(m[j], shfl(s, j, carry_lanes<D>()));
#pragma unroll
  for (int lev = 0; (1 << lev) <= D; ++lev) {
#pragma unroll
    for (int q = 0; q + (1 << lev) <= D; q += 2 << lev)
      t[q] = carry_add(t[q], t[q + (1 << lev)]);
  }
  return t[0];
}

// A walker's steps s <- m s + add[q], q < steps, add[q] its lane's (hi, lo)
// words at src + 2 D q (src null: zero), each new state to emit(q, s).
// Every lane runs n_steps steps (the shuffles take the whole warp); a step
// at or past `steps` leaves s as it was.  The adds are loaded IIR_B_AHEAD
// steps ahead, in a ring of registers, so that a step waits on its
// arithmetic and not on L2.
template <typename C, int D, typename Emit>
__device__ __forceinline__ C walk(C s, const C (&m)[D], const double* src,
                                  int steps, int n_steps, Emit emit) {
  C e[IIR_B_AHEAD];
#pragma unroll
  for (int q = 0; q < IIR_B_AHEAD; ++q) {
    zero(e[q]);
    if (src != nullptr && q < steps) load_end(src + 2 * D * q, e[q]);
  }
  for (int q0 = 0; q0 < n_steps; q0 += IIR_B_AHEAD) {
#pragma unroll
    for (int u = 0; u < IIR_B_AHEAD; ++u) {
      const int q = q0 + u;                 // the same in every lane
      if (q >= n_steps) break;
      const C add = e[u];
      if (src != nullptr && q + IIR_B_AHEAD < steps)
        load_end(src + 2 * D * (q + IIR_B_AHEAD), e[u]);
      const C t = carry_step<C, D>(s, m, add);
      if (q < steps) {
        s = t;
        emit(q, s);
      }
    }
  }
  return s;
}

// a walker's lane: (walker, its entry ii, whether the entry exists)
template <int D>
__device__ __forceinline__ long long walker_of(int& ii, bool& entry) {
  const long long g = (long long)blockIdx.x * IIR_B_THREADS + threadIdx.x;
  const int i = (int)(g % carry_lanes<D>());
  ii = min(i, D - 1);
  entry = i < D;
  return g / carry_lanes<D>();
}

template <typename C, int D>
__device__ __forceinline__ void load_row(const C* mat, int ii, C (&m)[D]) {
#pragma unroll
  for (int j = 0; j < D; ++j) m[j] = mat[ii * D + j];
}

// B1: F[r, g] (g < G - 1) in fends (rows, G, D, 2); Psi (D, D) row-major
template <typename T, int D>
__global__ void __launch_bounds__(IIR_B_THREADS)
iir_group_ends_kernel(const double* __restrict__ ends,
                      const carry_t<T>* __restrict__ phi,
                      double* __restrict__ fends,
                      carry_t<T>* __restrict__ psi, int rows, int K, int M,
                      int G) {
  using C = carry_t<T>;
  int ii;
  bool entry;
  const long long wk = walker_of<D>(ii, entry);
  const long long n_local = (long long)rows * (G - 1);
  const bool local = wk < n_local;
  // Psi's column (a walker past the columns repeats the last, unstored)
  const int col = (int)min(max(wk - n_local, 0LL), (long long)D - 1);
  const long long r = local ? wk / (G - 1) : 0, g = local ? wk % (G - 1) : 0;
  C m[D], s;
  load_row(phi, ii, m);
  basis(s, !local && ii == col);
  s = walk<C, D>(s, m,
                 local ? ends + ((r * K + g * M) * D + ii) * 2 : nullptr, M,
                 M, [](int, C) {});
  if (!entry) return;
  if (local)
    store_end(fends + ((r * G + g) * D + ii) * 2, s);
  else if (wk - n_local < D)
    psi[ii * D + col] = s;
}

// B2: T[r, g] in tstarts (rows, G, D, 2), T_0 = zi
template <typename T, int D>
__global__ void __launch_bounds__(IIR_B_THREADS)
iir_group_starts_kernel(const T* __restrict__ zi,
                        const double* __restrict__ fends,
                        const carry_t<T>* __restrict__ psi,
                        double* __restrict__ tstarts, int rows, int G) {
  using C = carry_t<T>;
  int ii;
  bool entry;
  const long long wk = walker_of<D>(ii, entry);
  const bool live = entry && wk < rows;
  const long long r = min(wk, (long long)rows - 1);
  C m[D];
  load_row(psi, ii, m);
  const C s = from_signal(zi[r * D + ii]);
  double* tr = tstarts + (r * G * D + ii) * 2;
  if (live) store_end(tr, s);
  walk<C, D>(s, m, fends + (r * G * D + ii) * 2, G - 1, G - 1,
             [&](int q, C v) {
               if (live) store_end(tr + 2 * D * (q + 1), v);
             });
}

// B3: S[r, k] (k >= 1) in starts (rows, K, D), rounded to the signal's type
template <typename T, int D>
__global__ void __launch_bounds__(IIR_B_THREADS)
iir_chunk_starts_kernel(const double* __restrict__ ends,
                        const carry_t<T>* __restrict__ phi,
                        const double* __restrict__ tstarts,
                        T* __restrict__ starts, int rows, int K, int M,
                        int G) {
  using C = carry_t<T>;
  int ii;
  bool entry;
  const long long wk0 = walker_of<D>(ii, entry);
  const bool live = entry && wk0 < (long long)rows * G;
  const long long wk = min(wk0, (long long)rows * G - 1);
  const long long r = wk / G, g = wk % G;
  C m[D], s;
  load_row(phi, ii, m);
  load_end(tstarts + ((r * G + g) * D + ii) * 2, s);
  T* sr = starts + (r * K + g * M + 1) * D + ii;
  walk<C, D>(s, m, ends + ((r * K + g * M) * D + ii) * 2,
             (int)min((long long)M, K - 1 - g * M), M, [&](int q, C v) {
               if (live) store_signal(sr + (long long)q * D, v);
             });
}

// ---- C: the output, chunk by chunk in the signal's type ----

template <typename T, int D>
__global__ void __launch_bounds__(IIR_THREADS)
iir_output_kernel(const T* __restrict__ x, const T* __restrict__ coef,
                  const T* __restrict__ zi, const T* __restrict__ starts,
                  T* __restrict__ y, T* __restrict__ zf, long long n, int K,
                  int groups) {
  constexpr int TT = iir_tile<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);   // [IIR_BUFS][IIR_W][TT + 1]
  const int r = blockIdx.x / groups;
  const long long k0 = (long long)(blockIdx.x - r * groups) * IIR_W;
  const int nc = (int)min((long long)IIR_W, K - k0);
  const int c = threadIdx.x;
  const bool walker = c < nc;
  // the chunk whose state this thread reads (a memory-warp thread or a lane
  // past the block's last chunk reads a valid one and never walks)
  const long long k = k0 + min(c % IIR_W, nc - 1);
  const T* xr = x + (long long)r * n;
  T* yr = y + (long long)r * n;

  T b[D + 1], a[D], s[D];
  load_coef<T, T, D>(coef, b, a);
  const T* s0 = k == 0 ? zi + (long long)r * D
                       : starts + ((long long)r * K + k) * D;
#pragma unroll
  for (int j = 0; j < D; ++j) s[j] = s0[j];

  // tiles of the block's longest chunk, its first
  const int P = (int)((min((long long)IIR_L, n - k0 * IIR_L) + TT - 1) / TT);
  if (c >= IIR_W && P > 0) load_tile(xr, stage, k0, nc, n, 0);
  __syncthreads();
  for (int p = 0; p <= P; ++p) {
    if (c < IIR_W) {
      if (walker && p < P) {
        T* row = stage + ((p % IIR_BUFS) * IIR_W + c) * (TT + 1);
        const int len = tile_len<T>(k, p, n);
#pragma unroll 4
        for (int i = 0; i < len; ++i) row[i] = step(s, row[i], b, a);
      }
    } else {
      if (p >= 1)
        store_tile(yr, stage + ((p - 1) % IIR_BUFS) * IIR_W * (TT + 1), k0,
                   nc, n, p - 1);
      if (p + 1 < P)
        load_tile(xr, stage + ((p + 1) % IIR_BUFS) * IIR_W * (TT + 1), k0,
                  nc, n, p + 1);
    }
    __syncthreads();
  }
  if (walker && k == K - 1) {
#pragma unroll
    for (int j = 0; j < D; ++j) zf[(long long)r * D + j] = s[j];
  }
}

// C without y: one thread a row walks the row's last chunk from its start
// state (zi where the row is one chunk) in iir_output_kernel's operations
// and writes only zf.  The chunk's samples are read straight from x,
// uncoalesced: one chunk a row is a small share of the call (batching the
// loads ahead of the steps measured no faster on the H100).
template <typename T, int D>
__global__ void __launch_bounds__(IIR_B_THREADS)
iir_final_state_kernel(const T* __restrict__ x, const T* __restrict__ coef,
                       const T* __restrict__ zi, const T* __restrict__ starts,
                       T* __restrict__ zf, int rows, long long n, int K) {
  const long long r = (long long)blockIdx.x * IIR_B_THREADS + threadIdx.x;
  if (r >= rows) return;
  T b[D + 1], a[D], s[D];
  load_coef<T, T, D>(coef, b, a);
  const T* s0 = K == 1 ? zi + r * D : starts + (r * K + K - 1) * D;
#pragma unroll
  for (int j = 0; j < D; ++j) s[j] = s0[j];
  const T* xr = x + r * n;
  for (long long i = (long long)(K - 1) * IIR_L; i < n; ++i)
    step(s, xr[i], b, a);
#pragma unroll
  for (int j = 0; j < D; ++j) zf[r * D + j] = s[j];
}

// the dynamic shared memory of one thread block of A and C: the staged tiles
template <typename T>
constexpr int smem_bytes() {
  return IIR_BUFS * IIR_W * (iir_tile<T>() + 1) * (int)sizeof(T);
}

// the carry's groups of a row of K > 1 chunks
static int carry_groups(long long K) {
  return (int)((K - 2) / IIR_B_GROUP + 1);
}

// the chunks of a row of n samples
static long long chunks(long long n) {
  return n > 0 ? (n + IIR_L - 1) / IIR_L : 1;
}

// float64 words of wf_iir_df2t's `work`: Phi, Psi (D, D, 2) each, then F
// and T (rows, G, D, 2) each
static long long work_doubles(int rows, long long n, int d) {
  const long long K = chunks(n);
  return 4LL * d * d + 4LL * rows * (K > 1 ? carry_groups(K) : 1) * d;
}

static int blocks_of(long long threads) {
  return (int)((threads + IIR_B_THREADS - 1) / IIR_B_THREADS);
}

template <typename T, int D>
static int launch(const void* x, const void* coef, const void* zi, void* y,
                  void* zf, void* ends, void* starts, void* work, int rows,
                  long long n, cudaStream_t st) {
  using C = carry_t<T>;
  const int smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      iir_chunk_ends_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(iir_output_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return (int)err;
  const long long K = chunks(n);
  const long long groups_c = (K + IIR_W - 1) / IIR_W;
  constexpr int W = carry_lanes<D>();
  if (K > INT_MAX || rows * groups_c >= INT_MAX ||
      (long long)rows * K * W >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  if (K > 1) {
    const int M = IIR_B_GROUP, G = carry_groups(K);
    double* w = (double*)work;
    C* phi = (C*)w;
    C* psi = (C*)(w + 2 * D * D);
    double* fends = w + 4 * D * D;
    double* tstarts = fends + 2LL * rows * G * D;
    const long long groups_a = (K - 1 + IIR_W - 1) / IIR_W;
    iir_chunk_ends_kernel<T, D><<<(int)(rows * groups_a) + 1, IIR_THREADS,
                                  smem, st>>>(
        (const T*)x, (const T*)coef, (double*)ends, phi, n, (int)K,
        (int)groups_a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (G > 1) {
      iir_group_ends_kernel<T, D><<<
          blocks_of(((long long)rows * (G - 1) + D) * W), IIR_B_THREADS, 0,
          st>>>((const double*)ends, phi, fends, psi, rows, (int)K, M, G);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    iir_group_starts_kernel<T, D><<<blocks_of((long long)rows * W),
                                    IIR_B_THREADS, 0, st>>>(
        (const T*)zi, fends, psi, tstarts, rows, G);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    iir_chunk_starts_kernel<T, D><<<blocks_of((long long)rows * G * W),
                                    IIR_B_THREADS, 0, st>>>(
        (const double*)ends, phi, tstarts, (T*)starts, rows, (int)K, M, G);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (y == nullptr) {                        // the state-only call
    iir_final_state_kernel<T, D><<<blocks_of(rows), IIR_B_THREADS, 0, st>>>(
        (const T*)x, (const T*)coef, (const T*)zi, (const T*)starts, (T*)zf,
        rows, n, (int)K);
    return (int)cudaGetLastError();
  }
  iir_output_kernel<T, D><<<(int)(rows * groups_c), IIR_THREADS, smem, st>>>(
      (const T*)x, (const T*)coef, (const T*)zi, (const T*)starts, (T*)y,
      (T*)zf, n, (int)K, (int)groups_c);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(int d, const void* x, const void* coef, const void* zi,
                    void* y, void* zf, void* ends, void* starts, void* work,
                    int rows, long long n, cudaStream_t st) {
  switch (d) {
#define WF_IIR_CASE(D) \
  case D:              \
    return launch<T, D>(x, coef, zi, y, zf, ends, starts, work, rows, n, st);
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
// `dtype` 0 is float64, 1 float32, for every one of those pointers.  The
// scratch: `ends` (rows, K, d, 2) float64 and `starts` (rows, K, d) of the
// signal's type, K = max(1, ceil(n / wf_iir_df2t_chunk())), and `work`,
// wf_iir_df2t_work_doubles(rows, n, d) float64.  Launches up to five
// kernels and returns the first non-zero cudaGetLastError() after one (0 on
// success), or cudaErrorInvalidValue for a state of more than IIR_MAX_D (or
// fewer than 1) entries, another dtype or too large a grid.  With y null it
// writes zf alone (the state-only call: the output pass becomes one walk
// of each row's last chunk), equal to the full call's.
int wf_iir_df2t(const void* x, const void* coef, const void* zi, void* y,
                void* zf, void* ends, void* starts, void* work, int rows,
                long long n, int d, int dtype, void* stream) {
  if (d < 1 || d > wfiir::IIR_MAX_D || rows < 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return wfiir::dispatch<double>(d, x, coef, zi, y, zf, ends, starts, work,
                                   rows, n, st);
  if (dtype == 1)
    return wfiir::dispatch<float>(d, x, coef, zi, y, zf, ends, starts, work,
                                  rows, n, st);
  return (int)cudaErrorInvalidValue;
}

// The float64 words of wf_iir_df2t's `work` for `rows` rows of n samples
// and a state of d.
long long wf_iir_df2t_work_doubles(int rows, long long n, int d) {
  return wfiir::work_doubles(rows, n, d);
}

// The samples a chunk of the blocked scan.
int wf_iir_df2t_chunk() { return wfiir::IIR_L; }

// The dynamic shared memory bytes wf_iir_df2t gives each thread block of its
// staged phases (A and C) for `dtype` (0 float64, 1 float32), or -1 for
// another dtype.
int wf_iir_df2t_smem_bytes(int dtype) {
  if (dtype == 0) return wfiir::smem_bytes<double>();
  if (dtype == 1) return wfiir::smem_bytes<float>();
  return -1;
}

}  // extern "C"
