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
// Grid: blockIdx.y walks the channels, blockIdx.x the samples, a block
// TRACE_THREADS threads of TRACE_SPT samples each.  At each sample a thread
// reads t from the grid, finds its segment in each of the channel's
// waveforms by a binary search on the bounds (so the grid need not be
// sorted), evaluates only that segment's terms (a ZERO segment costs the
// search), clips before the sum, and adds a WaveVStack's members to its
// offset in the evaluator's order.  Values are complex only where the IR
// makes them so (a complex coefficient, a complex external slot, or a
// complex argument of exp, cos, cosh, sinh, sinc, gaussian or interp's
// points); a real value carries no imaginary part.  The output is written
// in place: the real part, the imaginary part, or interleaved (re, im)
// pairs.
//
// What bounds it: at the flagship's occupancy, the store (2.048 GB of f64
// at 128 x 2,000,000); at the dense stratum's, the FP64 transcendental
// functions of each sample (a chirp's sin, a gaussian's exp).  The tape is
// read through the read-only cache: every thread of a block walks the same
// few records (one channel, mostly one segment), so a tape of any size is
// read from global memory, never declined.  Speed is later work: no shared
// memory staging, no wgmma or TMA.
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

// vals ** n by the power's kind (trace_tape.POW_KINDS; 8 the general pow)
template <typename T>
__device__ Val<T> vpow(Val<T> v, int kind, T n) {
  if (!v.cx) {
    T x = v.re;
    switch (kind) {
      case 1: return v;
      case 2: return real_val(x * x);
      case 3: return real_val(x * x * x);
      case 4: return real_val((T)1 / x);
      case 5: return real_val((T)1 / (x * x));
      case 6: return real_val(m_sqrt(x));
      case 7: return real_val(m_rsqrt(x));
      default: return real_val(m_pow(x, n));
    }
  }
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

template <typename T>
__device__ Val<T> factor(const Ctx<T>& x, int uf, T t) {
  const int* u = x.p + x.o_uf + uf * R_UF;
  int code = ldi(u, 0), off = ldi(u, 1);
  if (code == 0) {   // an external slot: its plane's value at this sample
    long long at = (long long)ldi(u, 2) * x.N + x.n;
    if (ldi(u, 3)) return {x.ext_re[at], x.ext_im[at], true};
    return real_val(x.ext_re[at]);
  }
  T ts = t - ld<T>(x.d, off);
  if (ldi(u, 3)) return basis_cx<T>(code, ts, x.d + off + 1, ldi(u, 2));
  return real_val(basis<T>(code, ts, x.d + off + 1));
}

// one segment's expression: its terms summed in order, each the product of
// its factors' powers times the coefficient
template <typename T>
__device__ Val<T> expr(const Ctx<T>& x, int tm0, int nt, T t) {
  Val<T> acc = real_val((T)0);
  for (int k = 0; k < nt; ++k) {
    const int* tm = x.p + x.o_tm + (tm0 + k) * R_TM;
    int f0 = ldi(tm, 0), nf = ldi(tm, 1), coff = ldi(tm, 2);
    int flags = ldi(tm, 3);
    bool ccx = flags & COEF_COMPLEX;
    Val<T> coef = {ld<T>(x.d, coff), ccx ? ld<T>(x.d, coff + 1) : (T)0, ccx};
    Val<T> term;
    if (nf == 0) {
      term = coef;
    } else {
      Val<T> prod;
      for (int j = 0; j < nf; ++j) {
        const int* tf = x.p + x.o_tf + (f0 + j) * R_TF;
        Val<T> v = factor(x, ldi(tf, 0), t);
        v = vpow(v, ldi(tf, 1), ld<T>(x.d, ldi(tf, 2)));
        prod = j == 0 ? v : vmul(prod, v);
      }
      term = (flags & COEF_ONE) ? prod : vmul(prod, coef);
    }
    acc = k == 0 ? term : vadd(acc, term);
  }
  return acc;
}

// a waveform's record, read once a thread
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

// a live segment's value at t, clipped (out of line: most samples of a
// sparse schedule find a ZERO segment and never call it)
template <typename T>
__device__ __noinline__ Val<T> segment(Ctx<T> x, Wave wv, int tm0, int nt,
                                       T t) {
  Val<T> v = expr(x, tm0, nt, t);
  if (wv.clip) {   // torch.clamp: NaN stays NaN
    T vmin = ld<T>(wv.bounds, wv.ns), vmax = ld<T>(wv.bounds, wv.ns + 1);
    if (v.re == v.re) v.re = m_fmin(m_fmax(v.re, vmin), vmax);
  }
  return v;
}

// one waveform at t: its segment by a binary search on the bounds, that
// segment's expression, clipped; outside every segment or in a ZERO one, 0
template <typename T>
__device__ __forceinline__ Val<T> wave(const Ctx<T>& x, const Wave& wv,
                                       T t) {
  int lo = 0, hi = wv.ns;   // the count of bounds <= t
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (ld<T>(wv.bounds, mid) <= t) lo = mid + 1; else hi = mid;
  }
  if (lo >= wv.ns) return real_val((T)0);
  const int* sg = x.p + x.o_sg + (wv.s0 + lo) * R_SG;
  int nt = ldi(sg, 1);
  if (nt == 0) return real_val((T)0);
  return segment(x, wv, ldi(sg, 0), nt, t);
}

// a block: TRACE_THREADS threads, TRACE_SPT samples each, neighbouring
// threads on neighbouring samples (the channel's records read once a block)
constexpr int TRACE_THREADS = 256, TRACE_SPT = 8;
constexpr int TRACE_BLOCK = TRACE_THREADS * TRACE_SPT;

template <typename T, int MODE>
__global__ void __launch_bounds__(TRACE_THREADS)
trace_eval_kernel(const int* __restrict__ p, const double* __restrict__ d,
                  const T* __restrict__ grid, long long N,
                  const T* __restrict__ ext_re, const T* __restrict__ ext_im,
                  T* __restrict__ out, int n_ch) {
  Ctx<T> x{p, d, ext_re, ext_im, 0, N, ldi(p, H_WV), ldi(p, H_SG),
           ldi(p, H_TM), ldi(p, H_TF), ldi(p, H_UF)};
  int tape_ch = ldi(p, H_NCH), o_ch = ldi(p, H_CH);
  for (int c = blockIdx.y; c < n_ch && c < tape_ch; c += gridDim.y) {
    const int* ch = p + o_ch + c * R_CH;
    int w0 = ldi(ch, 0), nw = ldi(ch, 1), coff = ldi(ch, 2);
    bool stack = ldi(ch, 3) != 0;
    T off_re = ld<T>(d, coff), off_im = ld<T>(d, coff + 1);
    T shift = ld<T>(d, coff + 2);
    const Wave first = nw ? wave_rec(x, w0) : Wave{0, 0, d, false};
    const long long step = (long long)gridDim.x * TRACE_BLOCK;
    for (long long base = (long long)blockIdx.x * TRACE_BLOCK; base < N;
         base += step) {
      // the block's samples of the grid first, all loads in flight at once
      T tv[TRACE_SPT];
#pragma unroll
      for (int k = 0; k < TRACE_SPT; ++k) {
        long long n = base + (long long)k * TRACE_THREADS + threadIdx.x;
        tv[k] = n < N ? grid[n] : (T)0;
      }
#pragma unroll
      for (int k = 0; k < TRACE_SPT; ++k) {
        long long n = base + (long long)k * TRACE_THREADS + threadIdx.x;
        if (n < N) {
          x.n = n;
          Val<T> acc;
          if (!stack) {
            acc = wave(x, first, tv[k]);
          } else {   // the offset, then each member over the grid less
                     // the shift
            T tt = shift != (T)0 ? tv[k] - shift : tv[k];
            acc = {off_re, off_im, true};
            for (int w = 0; w < nw; ++w)
              acc = vadd(acc, wave(x, wave_rec(x, w0 + w), tt));
            acc.cx = false;   // a WaveVStack evaluates to its real part
          }
          long long at = (long long)c * N + n;
          if (MODE == 0) {
            out[at] = acc.re;
          } else if (MODE == 1) {
            out[at] = acc.cx ? acc.im : (T)0;
          } else {
            out[2 * at] = acc.re;
            out[2 * at + 1] = acc.cx ? acc.im : (T)0;
          }
        }
      }
    }
  }
}

template <typename T, int MODE>
int launch(const int* prog, const double* pool, const void* grid,
           long long n, const void* ext_re, const void* ext_im, void* out,
           int n_ch, cudaStream_t stream) {
  long long blocks = (n + TRACE_BLOCK - 1) / TRACE_BLOCK;
  dim3 g((unsigned)(blocks < 2147483647LL ? blocks : 2147483647LL),
         (unsigned)(n_ch < 65535 ? n_ch : 65535));
  trace_eval_kernel<T, MODE><<<g, TRACE_THREADS, 0, stream>>>(
      prog, pool, (const T*)grid, n, (const T*)ext_re, (const T*)ext_im,
      (T*)out, n_ch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float64, 1 float32 (the grid's, the planes' and the output's
// real type); mode: 0 real part, 1 imaginary part, 2 interleaved (re, im)
int wf_trace_eval(const int* prog, const double* pool, const void* grid,
                  long long n, const void* ext_re, const void* ext_im,
                  void* out, int n_ch, int dtype, int mode,
                  cudaStream_t stream) {
  if (n <= 0 || n_ch <= 0) return 0;
  if (dtype == 0) {
    if (mode == 0) return launch<double, 0>(prog, pool, grid, n, ext_re, ext_im, out, n_ch, stream);
    if (mode == 1) return launch<double, 1>(prog, pool, grid, n, ext_re, ext_im, out, n_ch, stream);
    if (mode == 2) return launch<double, 2>(prog, pool, grid, n, ext_re, ext_im, out, n_ch, stream);
  } else if (dtype == 1) {
    if (mode == 0) return launch<float, 0>(prog, pool, grid, n, ext_re, ext_im, out, n_ch, stream);
    if (mode == 1) return launch<float, 1>(prog, pool, grid, n, ext_re, ext_im, out, n_ch, stream);
    if (mode == 2) return launch<float, 2>(prog, pool, grid, n, ext_re, ext_im, out, n_ch, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
