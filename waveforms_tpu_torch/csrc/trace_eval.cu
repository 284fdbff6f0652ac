// The trace evaluator (T1): a trace tape over a sample grid, in one launch.
//
// A port kernel with no Pallas counterpart.  It replaces the XLA program
// that the JAX package's jax_eval.compile_waveform jits (engine 'xla'): the
// waveform IR evaluated in float64 (or float32) at every sample, no
// lowering to descriptors, the formulas of ops/torch_basis.py operation for
// operation.  The IR comes flattened into a tape (ops/trace_tape.py): int32
// records and a float64 pool,
//
//   prog = header[8] | channels | waveforms | segments | terms
//          | term factors | factors            (record layouts: trace_tape)
//
// Grid: blockIdx.x walks tiles of TRACE_TILE (2,048) samples, blockIdx.y
// groups of TRACE_GROUP (32) channels, or fewer where a short grid of many
// channels would not fill the card (group_size).  A block stages its tile
// of the grid in shared memory once (16-byte loads) for every channel of
// its group,
// and checks whether the tile is non-decreasing (t[i] <= t[i + 1] for
// every pair, so a NaN fails it).  On a sorted tile, one thread a channel
// finds the segments of the tile's first and last samples (for a
// WaveVStack, each member's on t - shift, which stays sorted): every
// sample of the tile lies between them.  A tile that lies in one ZERO
// segment or outside every segment (of every member) is stored as
// constants with 16-byte streaming stores (scalar ones at an unaligned
// head and tail); otherwise each sample searches only that range of
// segments, none where the range is one segment.  An unsorted tile
// searches each sample over all the bounds, as a grid need not be sorted.
// A sample that is NaN lies outside every segment (torch.searchsorted's
// answer in the plain version), except in a waveform of one unbounded
// segment, which evaluates every sample, NaN and +inf too (the plain
// version's whole-grid case).  Each sample's value is then the segment's
// terms in order, clipped before the sum, a WaveVStack's members added to
// its offset in the evaluator's order; the real part, the imaginary part
// or interleaved (re, im) pairs are written in place.
//
// Two builds of one evaluator (expr over Pick<T, REAL>::V): a tape with no
// complex coefficient, complex slot or complex pool slice (Tape.real)
// takes the real one, whose values are plain T; any other tape the
// general one, whose values are Val<T>, complex only where the IR makes
// them so (a complex coefficient, a complex external slot, or a complex
// argument of exp, cos, cosh, sinh, sinc, gaussian or interp's points).
// Both compute each sample's real part by the same operations, so they
// agree to the bit; the real build of the imaginary part is a store of
// zeros.
//
// What bounds it: at the flagship's occupancy (0.0073), the store of the
// plane (2.048 GB of f64 at 128 x 2,000,000), which the zero tiles'
// streaming stores serve: 99.6% of its (channel, tile) pairs are zero
// tiles, and on an H100 (700 W) it runs at about 0.8 of the store's byte
// bound; the grid crosses L2 once a channel group, not once a channel.
// At the dense stratum's (every sample live), the FP64 evaluation of each
// sample (a chirp's sin, a gaussian's exp) at the warps that 80 registers
// allow (about 7x the byte bound there on an H100; scaling the chirp's
// phase down 1000x leaves its time within 1%, so it is not the sin's
// argument reduction); the design takes the search out of it (one
// segment a tile), the complex flags for a real tape, and the call a
// sample (the evaluation is inlined).  The tape is read through the
// read-only cache: every thread of a block walks the same few records.
//
// Rounding: this file builds with -fmad=false, so each product and sum
// rounds as the plain version's torch operations do, one at a time; the
// math functions are CUDA's (libdevice), as torch's CUDA kernels call.
// vals ** n takes torch's CUDA pow rules: 2 -> x*x, 3 -> x*x*x, -1 -> 1/x,
// -2 -> 1/(x*x), 0.5 -> sqrt, -0.5 -> rsqrt, else pow.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum { H_NCH = 0, H_CH, H_WV, H_SG, H_TM, H_TF, H_UF };   // header words
constexpr int R_CH = 4, R_WV = 4, R_SG = 2, R_TM = 4, R_TF = 4, R_UF = 4;
constexpr int COEF_COMPLEX = 1, COEF_ONE = 2;
constexpr int MULTI_HEAD = 13;   // torch_basis.MULTI_HEAD

// the math functions in each type (the float ones are CUDA's f-suffixed)
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_sin(double x) { return sin(x); }
__device__ __forceinline__ float m_sin(float x) { return sinf(x); }
__device__ __forceinline__ double m_cos(double x) { return cos(x); }
__device__ __forceinline__ float m_cos(float x) { return cosf(x); }
__device__ __forceinline__ double m_erf(double x) { return erf(x); }
__device__ __forceinline__ float m_erf(float x) { return erff(x); }
__device__ __forceinline__ double m_cosh(double x) { return cosh(x); }
__device__ __forceinline__ float m_cosh(float x) { return coshf(x); }
__device__ __forceinline__ double m_sinh(double x) { return sinh(x); }
__device__ __forceinline__ float m_sinh(float x) { return sinhf(x); }
__device__ __forceinline__ double m_pow(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float m_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_rsqrt(double x) { return rsqrt(x); }
__device__ __forceinline__ float m_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double m_atan2(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float m_atan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double m_hypot(double x, double y) { return hypot(x, y); }
__device__ __forceinline__ float m_hypot(float x, float y) { return hypotf(x, y); }
__device__ __forceinline__ double m_fabs(double x) { return fabs(x); }
__device__ __forceinline__ float m_fabs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_floor(double x) { return floor(x); }
__device__ __forceinline__ float m_floor(float x) { return floorf(x); }
__device__ __forceinline__ double m_copysign(double x, double y) { return copysign(x, y); }
__device__ __forceinline__ float m_copysign(float x, float y) { return copysignf(x, y); }
__device__ __forceinline__ double m_fmin(double x, double y) { return fmin(x, y); }
__device__ __forceinline__ float m_fmin(float x, float y) { return fminf(x, y); }
__device__ __forceinline__ double m_fmax(double x, double y) { return fmax(x, y); }
__device__ __forceinline__ float m_fmax(float x, float y) { return fmaxf(x, y); }

// jnp.interp's zero-width test, np.spacing(np.finfo(dtype).eps)
template <typename T> __device__ __forceinline__ T interp_eps();
template <> __device__ __forceinline__ double interp_eps<double>() {
  return 4.930380657631324e-32;   // 2^-104
}
template <> __device__ __forceinline__ float interp_eps<float>() {
  return 1.4210854715202004e-14f;   // 2^-46
}

// pi and 2 pi as Python's np.pi and 2 * np.pi, rounded to T
template <typename T> __device__ __forceinline__ T pi_() {
  return (T)3.141592653589793;
}
template <typename T> __device__ __forceinline__ T two_pi() {
  return (T)6.283185307179586;
}

template <typename T>
struct Val {
  T re, im;
  bool cx;   // false: a real value (im is 0)
};

template <typename T>
__device__ __forceinline__ Val<T> real_val(T x) { return {x, (T)0, false}; }

template <typename T>
__device__ __forceinline__ Val<T> vmul(Val<T> a, Val<T> b) {
  if (!a.cx && !b.cx) return real_val(a.re * b.re);
  if (!a.cx) return {a.re * b.re, a.re * b.im, true};
  if (!b.cx) return {a.re * b.re, a.im * b.re, true};
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re, true};
}

template <typename T>
__device__ __forceinline__ Val<T> vadd(Val<T> a, Val<T> b) {
  if (!a.cx && !b.cx) return real_val(a.re + b.re);
  return {a.re + b.re, (a.cx ? a.im : (T)0) + (b.cx ? b.im : (T)0), true};
}

// the real build's products and sums, on plain T
__device__ __forceinline__ double vmul(double a, double b) { return a * b; }
__device__ __forceinline__ float vmul(float a, float b) { return a * b; }
__device__ __forceinline__ double vadd(double a, double b) { return a + b; }
__device__ __forceinline__ float vadd(float a, float b) { return a + b; }

// a build's value type: T (real) or Val<T> (general)
template <typename T, bool REAL> struct Pick { typedef Val<T> V; };
template <typename T> struct Pick<T, true> { typedef T V; };

template <typename T, bool REAL>
__device__ __forceinline__ typename Pick<T, REAL>::V zero_val() {
  if constexpr (REAL) return (T)0; else return real_val((T)0);
}

template <typename T> __device__ __forceinline__ T re_of(T v) { return v; }
template <typename T> __device__ __forceinline__ T im_of(T) { return (T)0; }
template <typename T> __device__ __forceinline__ T& re_ref(T& v) {
  return v;
}
template <typename T> __device__ __forceinline__ T re_of(Val<T> v) {
  return v.re;
}
template <typename T> __device__ __forceinline__ T im_of(Val<T> v) {
  return v.cx ? v.im : (T)0;
}
template <typename T> __device__ __forceinline__ T& re_ref(Val<T>& v) {
  return v.re;
}

template <typename T>
__device__ __forceinline__ Val<T> vrecip(Val<T> a) {
  if (!a.cx) return real_val((T)1 / a.re);
  T d = a.re * a.re + a.im * a.im;
  return {a.re / d, -a.im / d, true};
}

template <typename T>
__device__ Val<T> csqrt(Val<T> z) {
  T a = z.re, b = z.im;
  if (a == (T)0 && b == (T)0) return {(T)0, b, true};
  T r = m_hypot(a, b);
  if (a >= (T)0) {
    T u = m_sqrt((r + a) / (T)2);
    return {u, b / ((T)2 * u), true};
  }
  T v = m_copysign(m_sqrt((r - a) / (T)2), b);
  return {b / ((T)2 * v), v, true};
}

template <typename T>
__device__ Val<T> cpow(Val<T> z, T n) {
  // integer powers by products (torch: thrust::pow); others exp(n log z)
  if (n == m_floor(n) && m_fabs(n) <= (T)64) {
    int k = (int)m_fabs(n);
    Val<T> acc = {(T)1, (T)0, true}, b = z;
    bool first = true;
    while (k) {
      if (k & 1) { acc = first ? b : vmul(acc, b); first = false; }
      k >>= 1;
      if (k) b = vmul(b, b);
    }
    return n < (T)0 ? vrecip(acc) : acc;
  }
  T lr = m_log(m_hypot(z.re, z.im)), li = m_atan2(z.im, z.re);
  T wr = n * lr, wi = n * li;
  T e = m_exp(wr);
  return {e * m_cos(wi), e * m_sin(wi), true};
}

// vals ** n by the power's kind (trace_tape.POW_KINDS; 8 the general pow),
// of a real value, then of a Val
template <typename T>
__device__ __forceinline__ T vpow(T x, int kind, T n) {
  switch (kind) {
    case 1: return x;
    case 2: return x * x;
    case 3: return x * x * x;
    case 4: return (T)1 / x;
    case 5: return (T)1 / (x * x);
    case 6: return m_sqrt(x);
    case 7: return m_rsqrt(x);
    default: return m_pow(x, n);
  }
}

template <typename T>
__device__ Val<T> vpow(Val<T> v, int kind, T n) {
  if (!v.cx) return real_val(vpow(v.re, kind, n));
  switch (kind) {
    case 1: return v;
    case 4: return vrecip(v);
    case 6: return csqrt(v);
    case 7: return vrecip(csqrt(v));
    default: return cpow(v, n);
  }
}

template <typename T>
__device__ __forceinline__ T ld(const double* __restrict__ d, int i) {
  return (T)__ldg(d + i);
}

__device__ __forceinline__ int ldi(const int* __restrict__ p, int i) {
  return __ldg(p + i);
}

// jnp.polyval from zero, highest power first, over n coefficients at a
template <typename T>
__device__ T polyval(const double* __restrict__ a, int n, T x) {
  T y = (T)0;
  for (int k = 0; k < n; ++k) y = y * x + ld<T>(a, k);
  return y;
}

// -- the built-in bases (IDs of ir/registry.py), each after torch_basis's
// -- apply; a is the factor's pool slice (torch_basis's pack)

// one part (the real or the imaginary) of interp's value: fp at the edge
// where t is outside [xp[0], xp[n - 1]], else fp[i - 1] + q (fp[i] -
// fp[i - 1]) (q = delta / dx), fp[i - 1] on a zero-width interval
template <typename T>
__device__ __forceinline__ T interp_part(const double* __restrict__ f, int i,
                                         T q, bool dx0, int edge) {
  if (edge >= 0) return ld<T>(f, edge);
  T f0 = ld<T>(f, i - 1);
  return dx0 ? f0 : f0 + q * (ld<T>(f, i) - f0);
}

// pool: n, xp[n], fp[n] (ai: the imaginary parts of complex points, at the
// same offsets; null for real points)
template <typename T>
__device__ Val<T> b_interp(T t, const double* __restrict__ a,
                           const double* __restrict__ ai) {
  int n = (int)__ldg(a);
  const double* xp = a + 1;
  int i = 1, edge = 0;
  bool dx0 = false;
  T q = (T)0;
  if (n > 1) {
    int lo = 0, hi = n;   // torch.searchsorted(xp, t, right=True)
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (ld<T>(xp, mid) <= t) lo = mid + 1; else hi = mid;
    }
    i = min(max(lo, 1), n - 1);
    T dx = ld<T>(xp, i) - ld<T>(xp, i - 1);
    T delta = t - ld<T>(xp, i - 1);
    dx0 = m_fabs(dx) <= interp_eps<T>();
    q = delta / (dx0 ? (T)1 : dx);
    edge = t > ld<T>(xp, n - 1) ? n - 1 : t < ld<T>(xp, 0) ? 0 : -1;
  }
  T re = interp_part(a + 1 + n, i, q, dx0, edge);
  if (!ai) return real_val(re);
  return {re, interp_part(ai + 1 + n, i, q, dx0, edge), true};
}

template <typename T>
__device__ T b_drag(T t, const double* __restrict__ a) {
  T t0 = ld<T>(a, 0), o = ld<T>(a, 1);
  T s = m_sin(o * (t - t0));
  T omega_x = s * s;
  T wt = ld<T>(a, 2) * t - ld<T>(a, 3);
  if (__ldg(a + 4) == 0.0) return omega_x * m_cos(wt);
  T omega_y = ld<T>(a, 5) * m_sin(ld<T>(a, 6) * (t - t0));
  return omega_x * m_cos(wt) + omega_y * m_sin(wt);
}

template <typename T>
__device__ T b_mollifier(T t, const double* __restrict__ a) {
  T r = ld<T>(a, 0);
  int d = (int)__ldg(a + 1);
  T x = t / r;
  T ax = m_fabs(x);
  T xx_1 = ax * ax - (T)1;
  bool out = xx_1 >= (T)0;
  T safe = out ? (T)-1 : xx_1;
  T bump = m_exp((T)1 / safe + (T)1);
  if (d == 0) return out ? (T)0 : bump;
  T q = -safe;
  T qp = d == 1 ? q * q : m_pow(q, (T)(2 * d));
  T w = out ? (T)0 : bump / qp;
  return w * polyval<T>(a + 4, (int)__ldg(a + 3), x) / ld<T>(a, 2);
}

template <typename T>
__device__ T b_d_gaussian(T t, const double* __restrict__ a) {
  T u = t / ld<T>(a, 0);
  T y = polyval<T>(a + 3, (int)__ldg(a + 2), u);
  return ld<T>(a, 1) * y * m_exp(-(u * u));
}

// multi-tone DRAG (IDs 16, 17): the sin^p envelope rows, A @ rows, the
// plateau's row 0, drag_sinx's blend polynomials, then B's two columns
template <typename T>
__device__ T b_multi(T t, const double* __restrict__ a, bool sinx) {
  T t0 = ld<T>(a, 0), e1 = ld<T>(a, 1), e2 = ld<T>(a, 2);
  T plateau = ld<T>(a, 3), o = ld<T>(a, 4);
  int m = (int)__ldg(a + 5), nb = (int)__ldg(a + 6);
  const double* A = a + MULTI_HEAD;
  const double* B0 = A + (nb + 1) * (m + 1);
  const double* B1 = B0 + nb + 1;
  const double* poly = B1 + nb + 1;
  bool rise = t <= e1;
  bool flat = t > e1 && t < e2;
  T base_t = rise ? t - t0 : t - t0 - plateau;
  T s = flat ? (T)0 : m_sin(o * base_t);
  T c = flat ? (T)0 : m_cos(o * base_t);
  bool left = false, right = false;
  T dt_left = (T)0, dt_right = (T)0;
  if (sinx) {
    T half = ld<T>(a, 12);
    left = t >= ld<T>(a, 10) && t <= e1;
    right = t >= e2 && t <= ld<T>(a, 11);
    dt_left = t - t0 - half;
    dt_right = t - t0 - plateau - half;
  }
  T om0 = (T)0, om1 = (T)0;
  for (int i = 0; i <= nb; ++i) {
    T row = (T)0;
    for (int p = 0; p <= m; ++p) {
      T e = m_pow(s, (T)p);
      if (p & 1) e = e * c;
      T term = ld<T>(A, i * (m + 1) + p) * e;
      row = p == 0 ? term : row + term;
    }
    if (i == 0 && flat) row = (T)1;
    if (sinx) {
      int nl = (int)__ldg(poly);
      if (left) row = polyval<T>(poly + 1, nl, dt_left);
      poly += 1 + nl;
      int nr = (int)__ldg(poly);
      if (right) row = polyval<T>(poly + 1, nr, dt_right);
      poly += 1 + nr;
    }
    T p0 = ld<T>(B0, i) * row, p1 = ld<T>(B1, i) * row;
    om0 = i == 0 ? p0 : om0 + p0;
    om1 = i == 0 ? p1 : om1 + p1;
  }
  if (!sinx) {
    T coeff = ld<T>(a, 7);
    om0 = om0 / coeff;
    om1 = om1 / coeff;
  }
  T wt = ld<T>(a, 8) * t - ld<T>(a, 9);
  return om0 * m_cos(wt) + om1 * m_sin(wt);
}

template <typename T>
__device__ T basis(int code, T t, const double* __restrict__ a) {
  switch (code) {
    case 1:   // LINEAR
      return t;
    case 2: {   // GAUSSIAN
      T u = t / ld<T>(a, 0);
      return m_exp(-(u * u));
    }
    case 3:   // ERF
      return m_erf(t / ld<T>(a, 0));
    case 4:   // COS
      return m_cos(ld<T>(a, 0) * t);
    case 5: {   // SINC, normalized (torch.sinc)
      T x = ld<T>(a, 0) * t;
      if (x == (T)0) return (T)1;
      T product = pi_<T>() * x;
      return m_sin(product) / product;
    }
    case 6:   // EXP
      return m_exp(ld<T>(a, 0) * t);
    case 7:   // INTERP
      return b_interp(t, a, (const double*)nullptr).re;
    case 8:   // LINEARCHIRP: phi0, (f1 - f0) / (2 T), f0
      return m_sin(two_pi<T>() * (ld<T>(a, 1) * (t * t) + ld<T>(a, 2) * t)
                   + ld<T>(a, 0));
    case 9:   // EXPONENTIALCHIRP: phi0, 2 pi f0, alpha
      return m_sin(ld<T>(a, 1) * (m_exp(ld<T>(a, 2) * t) - (T)1)
                   / ld<T>(a, 2) + ld<T>(a, 0));
    case 10:   // HYPERBOLICCHIRP: phi0, 2 pi f0 / k, k
      return m_sin(ld<T>(a, 1) * m_log(ld<T>(a, 2) * t + (T)1)
                   + ld<T>(a, 0));
    case 11:   // COSH
      return m_cosh(ld<T>(a, 0) * t);
    case 12:   // SINH
      return m_sinh(ld<T>(a, 0) * t);
    case 13:   // DRAG
      return b_drag(t, a);
    case 14:   // MOLLIFIER
      return b_mollifier(t, a);
    case 15:   // D_GAUSSIAN
      return b_d_gaussian(t, a);
    case 16:   // DRAG_SIN
      return b_multi(t, a, false);
    case 17:   // DRAG_SINX
      return b_multi(t, a, true);
  }
  return (T)0;
}

// -- complex arguments (torch_basis.COMPLEX_ARGS), after torch's complex
// -- kernels: w * t is (w.re t, w.im t), the functions thrust's formulas,
// -- the division c10::complex's (numpy's, with Smith's scaling)

template <typename T>
__device__ Val<T> cdiv(Val<T> a, Val<T> b) {
  T c = b.re, d = b.im;
  if (m_fabs(c) >= m_fabs(d)) {
    if (c == (T)0 && d == (T)0)
      return {a.re / m_fabs(c), a.im / m_fabs(d), true};
    T rat = d / c, scl = (T)1 / (c + d * rat);
    return {(a.re + a.im * rat) * scl, (a.im - a.re * rat) * scl, true};
  }
  T rat = c / d, scl = (T)1 / (d + c * rat);
  return {(a.re * rat + a.im) * scl, (a.im * rat - a.re) * scl, true};
}

template <typename T>
__device__ __forceinline__ Val<T> c_exp(T x, T y) {
  T e = m_exp(x);
  return {e * m_cos(y), e * m_sin(y), true};
}

template <typename T>
__device__ __forceinline__ Val<T> c_sin(T x, T y) {
  return {m_sin(x) * m_cosh(y), m_cos(x) * m_sinh(y), true};
}

// a: the pool slice's n real parts, then its n imaginary parts
template <typename T>
__device__ Val<T> basis_cx(int code, T t, const double* __restrict__ a,
                           int n) {
  const double* ai = a + n;
  T x = ld<T>(a, 0) * t, y = ld<T>(ai, 0) * t;   // w * t (not interp's)
  switch (code) {
    case 2: {   // GAUSSIAN: exp(-((t / w) ** 2))
      Val<T> u = cdiv(real_val(t), Val<T>{ld<T>(a, 0), ld<T>(ai, 0), true});
      Val<T> u2 = vmul(u, u);
      return c_exp(-u2.re, -u2.im);
    }
    case 4:   // COS: cos(x) cosh(y) - i sin(x) sinh(y)
      return {m_cos(x) * m_cosh(y), -(m_sin(x) * m_sinh(y)), true};
    case 5: {   // SINC: sin(pi z) / (pi z), 1 at z == 0
      if (x == (T)0 && y == (T)0) return {(T)1, (T)0, true};
      T px = pi_<T>() * x, py = pi_<T>() * y;
      return cdiv(c_sin(px, py), Val<T>{px, py, true});
    }
    case 6:   // EXP
      return c_exp(x, y);
    case 7:   // INTERP, complex points
      return b_interp(t, a, ai);
    case 11:   // COSH
      return {m_cosh(x) * m_cos(y), m_sinh(x) * m_sin(y), true};
    case 12:   // SINH
      return {m_sinh(x) * m_cos(y), m_cosh(x) * m_sin(y), true};
  }
  return {(T)0, (T)0, true};
}

template <typename T>
struct Ctx {
  const int* __restrict__ p;
  const double* __restrict__ d;
  const T* __restrict__ ext_re;
  const T* __restrict__ ext_im;
  long long n;        // this sample
  long long N;        // samples a row
  int o_wv, o_sg, o_tm, o_tf, o_uf;
};

// a factor's value at t (a real build's tape has no complex slot or
// argument)
template <typename T, bool REAL>
__device__ typename Pick<T, REAL>::V factor(const Ctx<T>& x, int uf, T t) {
  const int* u = x.p + x.o_uf + uf * R_UF;
  int code = ldi(u, 0), off = ldi(u, 1);
  if (code == 0) {   // an external slot: its plane's value at this sample
    long long at = (long long)ldi(u, 2) * x.N + x.n;
    if constexpr (REAL) return x.ext_re[at];
    else if (ldi(u, 3)) return {x.ext_re[at], x.ext_im[at], true};
    else return real_val(x.ext_re[at]);
  }
  T ts = t - ld<T>(x.d, off);
  if constexpr (REAL) return basis<T>(code, ts, x.d + off + 1);
  else if (ldi(u, 3)) return basis_cx<T>(code, ts, x.d + off + 1, ldi(u, 2));
  else return real_val(basis<T>(code, ts, x.d + off + 1));
}

// one segment's expression: its terms summed in order, each the product of
// its factors' powers times the coefficient
template <typename T, bool REAL>
__device__ typename Pick<T, REAL>::V expr(const Ctx<T>& x, int tm0, int nt,
                                          T t) {
  typedef typename Pick<T, REAL>::V V;
  V acc = zero_val<T, REAL>();
  for (int k = 0; k < nt; ++k) {
    const int* tm = x.p + x.o_tm + (tm0 + k) * R_TM;
    int f0 = ldi(tm, 0), nf = ldi(tm, 1), coff = ldi(tm, 2);
    int flags = ldi(tm, 3);
    V coef;
    if constexpr (REAL) {
      coef = ld<T>(x.d, coff);
    } else {
      bool ccx = flags & COEF_COMPLEX;
      coef = {ld<T>(x.d, coff), ccx ? ld<T>(x.d, coff + 1) : (T)0, ccx};
    }
    V term;
    if (nf == 0) {
      term = coef;
    } else {
      V prod = zero_val<T, REAL>();
      for (int j = 0; j < nf; ++j) {
        const int* tf = x.p + x.o_tf + (f0 + j) * R_TF;
        V v = vpow(factor<T, REAL>(x, ldi(tf, 0), t), ldi(tf, 1),
                   ld<T>(x.d, ldi(tf, 2)));
        prod = j == 0 ? v : vmul(prod, v);
      }
      term = (flags & COEF_ONE) ? prod : vmul(prod, coef);
    }
    acc = k == 0 ? term : vadd(acc, term);
  }
  return acc;
}

// a waveform's record
struct Wave {
  int s0, ns;                        // first segment, segment count
  const double* __restrict__ bounds;  // ns bounds, then the clip rails
  bool clip;
};

template <typename T>
__device__ __forceinline__ Wave wave_rec(const Ctx<T>& x, int w) {
  const int* wv = x.p + x.o_wv + w * R_WV;
  return {ldi(wv, 0), ldi(wv, 1), x.d + ldi(wv, 2), ldi(wv, 3) != 0};
}

template <typename T>
__device__ __forceinline__ int seg_terms(const Ctx<T>& x, const Wave& wv,
                                         int s) {
  return ldi(x.p + x.o_sg + (wv.s0 + s) * R_SG, 1);
}

// the count of bounds <= t among bounds [lo, hi) (lo bounds below them are
// known to be <= t, those from hi on > t): t's segment
template <typename T>
__device__ __forceinline__ int seg_count(const double* __restrict__ b, T t,
                                         int lo, int hi) {
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (ld<T>(b, mid) <= t) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// a live segment's value at t, clipped; inlined, in loops that are not
// unrolled: as a call, the registers saved around it and the spills under
// the register cap made dense slower (tools/ab_trace.py's `call` build)
template <typename T, bool REAL>
__device__ __forceinline__ typename Pick<T, REAL>::V segment(
    Ctx<T> x, Wave wv, int tm0, int nt, T t) {
  typename Pick<T, REAL>::V v = expr<T, REAL>(x, tm0, nt, t);
  if (wv.clip) {   // torch.clamp, of the real part: NaN stays NaN
    T vmin = ld<T>(wv.bounds, wv.ns), vmax = ld<T>(wv.bounds, wv.ns + 1);
    T& re = re_ref(v);
    if (re == re) re = m_fmin(m_fmax(re, vmin), vmax);
  }
  return v;
}

// the segments [lo, hi] (x, y) that a tile's samples lie in, from its
// first and last samples where it is sorted: every segment where it is
// not, and segment 0 for every sample (NaN and +inf too) of a waveform
// that is one unbounded segment, as the plain version's whole-grid case
template <typename T>
__device__ __forceinline__ int2 seg_range(const Wave& wv, bool sorted,
                                          T t_first, T t_last) {
  if (wv.ns == 1 && __ldg(wv.bounds) == (double)INFINITY)
    return make_int2(0, 0);
  if (!sorted) return make_int2(0, wv.ns);
  const int lo = seg_count(wv.bounds, t_first, 0, wv.ns);
  return make_int2(lo, seg_count(wv.bounds, t_last, lo, wv.ns));
}

// whether a waveform is 0 at every sample of a range: one segment, ZERO
// or past the last bound
template <typename T>
__device__ __forceinline__ bool seg_zero(const Ctx<T>& x, const Wave& wv,
                                         int2 r) {
  return r.x == r.y && (r.x >= wv.ns || seg_terms(x, wv, r.x) == 0);
}

// one waveform at t, whose segment lies in the range r (seg_range): found
// by a binary search there, that segment's expression, clipped; outside
// every segment or in a ZERO one, 0.  Searched, a NaN t lies outside every
// segment (torch.searchsorted's answer in the plain version)
template <typename T, bool REAL>
__device__ __forceinline__ typename Pick<T, REAL>::V wave_at(
    const Ctx<T>& x, const Wave& wv, T t, int2 r) {
  const int s = r.x == r.y ? r.x
                : t == t   ? seg_count(wv.bounds, t, r.x, r.y)
                           : wv.ns;
  if (s >= wv.ns) return zero_val<T, REAL>();
  const int* sg = x.p + x.o_sg + (wv.s0 + s) * R_SG;
  int nt = ldi(sg, 1);
  if (nt == 0) return zero_val<T, REAL>();
  return segment<T, REAL>(x, wv, ldi(sg, 0), nt, t);
}

// a block: TRACE_THREADS threads over a tile of TRACE_TILE samples (thread
// i on samples i, i + TRACE_THREADS, ...) for each of TRACE_GROUP channels
constexpr int TRACE_THREADS = 256, TRACE_SPT = 8;
constexpr int TRACE_TILE = TRACE_THREADS * TRACE_SPT;
constexpr int TRACE_GROUP = 32;   // the most channels a block (s_range)
// blocks an SM that the registers must allow: 3 caps them at 80
// (tools/ab_trace.py times 2 and 4 blocks, 128 and 64 registers, beside
// it)
constexpr int TRACE_MIN_BLOCKS = 3;

// 16 bytes of T, and a pattern of two values in it (v at the even
// elements, w at the odd ones, from an even first element)
template <typename T> struct Vec16;
template <> struct Vec16<double> {
  typedef double2 type;
  static __device__ __forceinline__ double2 of(double v, double w) {
    return make_double2(v, w);
  }
};
template <> struct Vec16<float> {
  typedef float4 type;
  static __device__ __forceinline__ float4 of(float v, float w) {
    return make_float4(v, w, v, w);
  }
};

// out[e] for e in [e0, e0 + ne) by the block: v where e is even, w where
// it is odd; 16-byte streaming stores (the plane is written once, not
// read back) between scalar ones at the unaligned ends
template <typename T>
__device__ __forceinline__ void fill(T* __restrict__ out, long long e0,
                                     long long ne, T v, T w) {
  typedef typename Vec16<T>::type V16;
  constexpr int V = 16 / sizeof(T);
  T* q = out + e0;
  long long head = (long long)((16 - ((uintptr_t)q & 15)) & 15) / sizeof(T);
  if (head > ne) head = ne;
  const long long nv = (ne - head) / V;
  for (long long i = threadIdx.x; i < head; i += TRACE_THREADS)
    q[i] = ((e0 + i) & 1) ? w : v;
  const V16 pat = ((e0 + head) & 1) ? Vec16<T>::of(w, v) : Vec16<T>::of(v, w);
  V16* qv = reinterpret_cast<V16*>(q + head);
  for (long long j = threadIdx.x; j < nv; j += TRACE_THREADS)
    __stcs(qv + j, pat);
  for (long long i = head + nv * V + threadIdx.x; i < ne; i += TRACE_THREADS)
    q[i] = ((e0 + i) & 1) ? w : v;
}

// n samples of a row, from sample `at` of the plane, all of value v (the
// imaginary part 0)
template <typename T, int MODE>
__device__ __forceinline__ void fill_tile(T* __restrict__ out, long long at,
                                          int n, T v) {
  if (MODE == 0) fill(out, at, n, v, v);
  else if (MODE == 1) fill(out, at, n, (T)0, (T)0);
  else fill(out, 2 * at, 2 * (long long)n, v, (T)0);
}

template <typename T, int MODE>
__device__ __forceinline__ void put(T* __restrict__ out, long long at, T re,
                                    T im) {
  if (MODE == 0) {
    out[at] = re;
  } else if (MODE == 1) {
    out[at] = im;
  } else {
    out[2 * at] = re;
    out[2 * at + 1] = im;
  }
}

// the grid's n samples from g into shared memory: 16-byte loads where the
// tile is whole and g aligned
template <typename T>
__device__ __forceinline__ void stage(T* s, const T* __restrict__ g, int n) {
  typedef typename Vec16<T>::type V16;
  constexpr int V = 16 / sizeof(T);
  if (n == TRACE_TILE && ((uintptr_t)g & 15) == 0) {
    for (int j = threadIdx.x; j < TRACE_TILE / V; j += TRACE_THREADS)
      reinterpret_cast<V16*>(s)[j] = __ldg(reinterpret_cast<const V16*>(g) + j);
  } else {
    for (int i = threadIdx.x; i < n; i += TRACE_THREADS) s[i] = g[i];
  }
}

// a WaveVStack's member grid: t less the shift
template <typename T>
__device__ __forceinline__ T shifted(T t, T shift) {
  return shift != (T)0 ? t - shift : t;
}

// a channel's range over a tile, s_range: x FILL where the tile is one
// constant, else a Waveform's seg_range (a WaveVStack's members each take
// their own)
constexpr int FILL = -1;

template <typename T, bool REAL, int MODE>
__global__ void __launch_bounds__(TRACE_THREADS, TRACE_MIN_BLOCKS)
trace_eval_kernel(const int* __restrict__ p, const double* __restrict__ d,
                  const T* __restrict__ grid, long long N,
                  const T* __restrict__ ext_re, const T* __restrict__ ext_im,
                  T* __restrict__ out, int n_ch, int group) {
  typedef typename Pick<T, REAL>::V Vt;
  __shared__ __align__(16) T s_t[TRACE_TILE];
  __shared__ int2 s_range[TRACE_GROUP];
  Ctx<T> x{p, d, ext_re, ext_im, 0, N, ldi(p, H_WV), ldi(p, H_SG),
           ldi(p, H_TM), ldi(p, H_TF), ldi(p, H_UF)};
  const int n_use = min(n_ch, ldi(p, H_NCH)), o_ch = ldi(p, H_CH);
  // this block's channels, [c0, c0 + nc): one group a block, no loop over
  // groups (which, with the group a runtime value, cost the evaluation
  // spills: tools/ab_trace.py)
  const int c0 = blockIdx.y * group;
  if (c0 >= n_use) return;
  const int nc = min(group, n_use - c0);
  const long long n_tiles = (N + TRACE_TILE - 1) / TRACE_TILE;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long base = tile * TRACE_TILE;
    const int n = (int)min((long long)TRACE_TILE, N - base);
    __syncthreads();   // the last tile's samples and ranges are read
    stage(s_t, grid + base, n);
    __syncthreads();
    bool up = true;
    for (int i = threadIdx.x; i + 1 < n; i += TRACE_THREADS)
      up = up && s_t[i] <= s_t[i + 1];
    const bool sorted = __syncthreads_and(up) && s_t[0] == s_t[0];
    const T t_first = s_t[0], t_last = s_t[n - 1];
    // each channel's range over the tile, one thread a channel
    for (int g = threadIdx.x; g < nc; g += TRACE_THREADS) {
      const int* ch = p + o_ch + (c0 + g) * R_CH;
      const int w0 = ldi(ch, 0), nw = ldi(ch, 1);
      int2 r = make_int2(FILL, 0);
      if (REAL && MODE == 1) {
        // a real tape's imaginary part: 0 throughout
      } else if (ldi(ch, 3) == 0) {   // a Waveform
        const Wave wv = nw ? wave_rec(x, w0) : Wave{0, 0, d, false};
        r = seg_range(wv, sorted, t_first, t_last);
        if (seg_zero(x, wv, r)) r.x = FILL;
      } else {   // a WaveVStack: constant where every member is 0
        const T shift = ld<T>(d, ldi(ch, 2) + 2);
        const bool srt = sorted && shift - shift == (T)0;   // finite
        for (int w = 0; r.x == FILL && w < nw; ++w) {
          const Wave wv = wave_rec(x, w0 + w);
          if (!seg_zero(x, wv, seg_range(wv, srt, shifted(t_first, shift),
                                         shifted(t_last, shift))))
            r.x = 0;
        }
      }
      s_range[g] = r;
    }
    __syncthreads();
    for (int g = 0; g < nc; ++g) {
      const int c = c0 + g;
      const int* ch = p + o_ch + c * R_CH;
      const int w0 = ldi(ch, 0), nw = ldi(ch, 1), coff = ldi(ch, 2);
      const bool stack = ldi(ch, 3) != 0;
      const long long row = (long long)c * N + base;
      const int2 r = s_range[g];
      if (r.x == FILL) {   // a Waveform's 0; a WaveVStack's offset + 0
        T v = (T)0;
        if (stack) {
          v = ld<T>(d, coff);
          if (nw) v = v + (T)0;
        }
        fill_tile<T, MODE>(out, row, n, v);
      } else if (!stack) {
        const Wave wv = nw ? wave_rec(x, w0) : Wave{0, 0, d, false};
#pragma unroll 1
        for (int i = threadIdx.x; i < n; i += TRACE_THREADS) {
          x.n = base + i;
          Vt v = wave_at<T, REAL>(x, wv, s_t[i], r);
          put<T, MODE>(out, row + i, re_of(v), im_of(v));
        }
      } else {   // the offset, then each member over the grid less the
                 // shift, members outermost; the real part
        const T shift = ld<T>(d, coff + 2);
        const bool srt = sorted && shift - shift == (T)0;
        T acc[TRACE_SPT];
#pragma unroll
        for (int k = 0; k < TRACE_SPT; ++k) acc[k] = ld<T>(d, coff);
        for (int w = 0; w < nw; ++w) {
          const Wave wv = wave_rec(x, w0 + w);
          const int2 rw = seg_range(wv, srt, shifted(t_first, shift),
                                    shifted(t_last, shift));
#pragma unroll 1
          for (int k = 0; k < TRACE_SPT; ++k) {
            const int i = k * TRACE_THREADS + threadIdx.x;
            if (i < n) {
              x.n = base + i;
              acc[k] = acc[k] + re_of(wave_at<T, REAL>(
                                    x, wv, shifted(s_t[i], shift), rw));
            }
          }
        }
#pragma unroll
        for (int k = 0; k < TRACE_SPT; ++k) {
          const int i = k * TRACE_THREADS + threadIdx.x;
          if (i < n) put<T, MODE>(out, row + i, acc[k], (T)0);
        }
      }
    }
  }
}

// channels a block: TRACE_GROUP, or as many fewer as a short grid of many
// channels needs for its tiles x groups blocks to fill TRACE_WAVES waves
// of the card (TRACE_MIN_BLOCKS a multiprocessor); at least 1, and at
// least what keeps the groups within a grid's 65,535 rows
constexpr int TRACE_WAVES = 2;
constexpr long long GRID_Y = 65535;

long long group_size(long long tiles, int n_ch) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
          != cudaSuccess)
    sms = 132;   // an H100 SXM's
  const long long want = (long long)sms * TRACE_MIN_BLOCKS * TRACE_WAVES;
  const long long g = tiles * n_ch / want;
  const long long least = (n_ch + GRID_Y - 1) / GRID_Y;
  const long long fit = g < 1 ? 1 : g > TRACE_GROUP ? TRACE_GROUP : g;
  return fit > least ? fit : least;
}

template <typename T, bool REAL, int MODE>
int launch(const int* prog, const double* pool, const void* grid,
           long long n, const void* ext_re, const void* ext_im, void* out,
           int n_ch, cudaStream_t stream) {
  const long long tiles = (n + TRACE_TILE - 1) / TRACE_TILE;
  const long long group = group_size(tiles, n_ch);
  if (group > TRACE_GROUP) return (int)cudaErrorInvalidValue;
  const long long groups = (n_ch + group - 1) / group;
  dim3 g((unsigned)(tiles < 2147483647LL ? tiles : 2147483647LL),
         (unsigned)groups);
  trace_eval_kernel<T, REAL, MODE><<<g, TRACE_THREADS, 0, stream>>>(
      prog, pool, (const T*)grid, n, (const T*)ext_re, (const T*)ext_im,
      (T*)out, n_ch, (int)group);
  return (int)cudaGetLastError();
}

template <typename T, bool REAL>
int launch_mode(int mode, const int* prog, const double* pool,
                const void* grid, long long n, const void* ext_re,
                const void* ext_im, void* out, int n_ch,
                cudaStream_t stream) {
  if (mode == 0) return launch<T, REAL, 0>(prog, pool, grid, n, ext_re, ext_im, out, n_ch, stream);
  if (mode == 1) return launch<T, REAL, 1>(prog, pool, grid, n, ext_re, ext_im, out, n_ch, stream);
  if (mode == 2) return launch<T, REAL, 2>(prog, pool, grid, n, ext_re, ext_im, out, n_ch, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float64, 1 float32 (the grid's, the planes' and the output's
// real type); mode: 0 real part, 1 imaginary part, 2 interleaved (re, im);
// real: 1 for a tape whose every value is real (trace_tape.Tape.real), the
// real build, else 0
int wf_trace_eval(const int* prog, const double* pool, const void* grid,
                  long long n, const void* ext_re, const void* ext_im,
                  void* out, int n_ch, int dtype, int mode, int real,
                  cudaStream_t stream) {
  if (n <= 0 || n_ch <= 0) return 0;
  if (dtype == 0) {
    if (real) return launch_mode<double, true>(mode, prog, pool, grid, n, ext_re, ext_im, out, n_ch, stream);
    return launch_mode<double, false>(mode, prog, pool, grid, n, ext_re, ext_im, out, n_ch, stream);
  }
  if (dtype == 1) {
    if (real) return launch_mode<float, true>(mode, prog, pool, grid, n, ext_re, ext_im, out, n_ch, stream);
    return launch_mode<float, false>(mode, prog, pool, grid, n, ext_re, ext_im, out, n_ch, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
