// lowerext: native IR -> descriptor lowering (CPython extension).
//
// Walks a channel's piecewise IR (nested Python tuples, see
// waveforms_tpu_torch/ir/algebra.py) directly via the C API and emits the same
// flat factor descriptors as waveforms_tpu_torch/ops/lowering.py -- the
// graph-construction role the reference gave its compiled Cython layer
// (feihoo87/waveforms/waveforms/_waveform.pyx), here producing the device
// descriptor program instead of walking tuples per sample.
//
// Channels using bases this walker does not cover (interp tables before
// expansion, multi-tone DRAG, user callbacks, fractional powers) return
// None and the caller falls back to the Python lowering -- semantics are
// identical either way (same formulas, same int32 fixed-point phase
// quantization, same searchsorted boundary rule on the shared f64 grid).
//
// Build: g++ -O3 -shared -fPIC -I<python-include> (see native/__init__.py).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <map>

#include <cmath>
#include <limits>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int W_ARGS = 12;
constexpr double kTwoPi = 6.283185307179586476925286766559;

// registry basis IDs (waveforms_tpu_torch/ir/registry.py, stable 1..15)
enum Basis : long {
  B_LINEAR = 1, B_GAUSSIAN = 2, B_ERF = 3, B_COS = 4, B_SINC = 5,
  B_EXP = 6, B_INTERP = 7, B_LINEARCHIRP = 8, B_EXPONENTIALCHIRP = 9,
  B_HYPERBOLICCHIRP = 10, B_COSH = 11, B_SINH = 12, B_DRAG = 13,
  B_MOLLIFIER = 14, B_D_GAUSSIAN = 15,
  // registered by models/multy_drag.py at package import (stable order)
  B_DRAG_SIN = 16, B_DRAG_SINX = 17,
};

// kernel opcodes (waveforms_tpu_torch/ops/lowering.py)
enum Op : int32_t {
  OP_LINEAR = 0, OP_GAUSSIAN = 1, OP_ERF = 2, OP_COS = 3, OP_SINC = 4,
  OP_EXP = 5, OP_LINEARCHIRP = 6, OP_EXPCHIRP = 7, OP_HYPCHIRP = 8,
  OP_COSH = 9, OP_SINH = 10, OP_DRAG = 11, OP_POLY_GAUSS = 12,
  OP_MOLLIFIER = 13, OP_DRAG_SIN = 15, OP_DRAG_SINX = 16,
};
constexpr int kDragSinMaxM = 12;   // DRAG_SIN_MAXM
constexpr int kDragSinNC = 13;     // DRAG_SIN_NC
constexpr int kDragSinxMaxQ = 40;  // DRAG_SINX_MAXQ

struct Unsupported {};  // thrown to trigger the Python fallback

// Validated tuple access: user-built Waveforms can carry malformed IR --
// any shape surprise must throw Unsupported (Python fallback raises the
// proper error), never read out of bounds.
static PyObject* tuple_item(PyObject* t, Py_ssize_t i) {
  if (!PyTuple_Check(t) || i < 0 || i >= PyTuple_GET_SIZE(t))
    throw Unsupported{};
  return PyTuple_GET_ITEM(t, i);
}
static Py_ssize_t tuple_size(PyObject* t) {
  if (!PyTuple_Check(t)) throw Unsupported{};
  return PyTuple_GET_SIZE(t);
}

struct FactorRow {
  int32_t op;
  int32_t power;
  int32_t shift_hi;
  int32_t q32[4];
  float a[W_ARGS];
};

struct Emit {
  // per segment: sample range + term count
  std::vector<int64_t> seg_lo, seg_hi;
  std::vector<int32_t> seg_nterm;
  // per term
  std::vector<float> term_amp;
  std::vector<int32_t> term_nfac;
  // per factor
  std::vector<FactorRow> facs;
  // float64 side-buffer + dedup of identical static blocks
  std::vector<double> ext;
  std::map<std::vector<double>, std::pair<int64_t, int64_t>>
      ext_index;  // dedup key -> (offset, length) of the shared block
};

double as_double(PyObject* o) {
  double v = PyFloat_AsDouble(o);
  // clear the indicator before throwing: Unsupported means "fall back
  // to the Python lowering", and a live PyErr would turn the fallback
  // into a user-visible TypeError at the return-None check
  if (v == -1.0 && PyErr_Occurred()) { PyErr_Clear(); throw Unsupported{}; }
  return v;
}

// f64 -> f32 with explicit overflow handling: static_cast past
// FLT_MAX is formally UB ([conv.double]); numpy's cast gives +-inf,
// so do that deliberately (reachable via high-order derivative chains)
float to_f32(double x) {
  if (x > static_cast<double>(std::numeric_limits<float>::max()))
    return std::numeric_limits<float>::infinity();
  if (x < -static_cast<double>(std::numeric_limits<float>::max()))
    return -std::numeric_limits<float>::infinity();
  return static_cast<float>(x);
}

long as_long(PyObject* o) {
  PyObject* idx = PyNumber_Index(o);
  if (!idx) { PyErr_Clear(); throw Unsupported{}; }
  long v = PyLong_AsLong(idx);
  Py_DECREF(idx);
  if (v == -1 && PyErr_Occurred()) { PyErr_Clear(); throw Unsupported{}; }
  return v;
}

void split_shift(double off_samples, int32_t* hi, double* frac) {
  double r = std::nearbyint(off_samples);
  if (r > 2147483000.0 || r < -2147483000.0) throw Unsupported{};
  *hi = static_cast<int32_t>(r);
  *frac = off_samples - r;
}

void phase_q32(double dphi_rad, int32_t* q32, double* eps) {
  double turns = dphi_rad / kTwoPi;
  double q = std::nearbyint(turns * 4294967296.0);
  *eps = dphi_rad - q * (kTwoPi / 4294967296.0);
  // wrap to signed int32 (mod 2^32)
  double m = std::fmod(q, 4294967296.0);
  if (m < 0) m += 4294967296.0;
  uint32_t u = static_cast<uint32_t>(m);
  *q32 = static_cast<int32_t>(u);
}

// Physicists' Hermite H_n coefficients, ascending (matches
// ir/registry.hermite_coefficients reversed)
void hermite_ascending(int n, double* c /* n+1 */) {
  std::vector<double> prev{1.0}, cur{0.0, 2.0};  // ascending H_0, H_1
  if (n == 0) { c[0] = 1.0; return; }
  for (int k = 1; k < n; ++k) {
    std::vector<double> nxt(k + 2, 0.0);
    for (size_t i = 0; i < cur.size(); ++i) nxt[i + 1] = 2.0 * cur[i];
    for (size_t i = 0; i < prev.size(); ++i) nxt[i] -= 2.0 * k * prev[i];
    prev.swap(cur);
    cur.swap(nxt);
  }
  for (int i = 0; i <= n; ++i) c[i] = cur[i];
}

// Mollifier derivative polynomial, ascending coefficients (matches
// ir/registry.mollifier_poly): p1 = -2x;
// p_{n+1} = (x^4 - 2x^2 + 1) p' + (-4n x^3 + (4n-2) x) p
std::vector<double> mollifier_poly_ascending(int d) {
  std::vector<double> p{0.0, -2.0};  // -2x
  for (int n = 1; n < d; ++n) {
    std::vector<double> dp(p.size() > 1 ? p.size() - 1 : 1, 0.0);
    for (size_t i = 1; i < p.size(); ++i) dp[i - 1] = p[i] * i;
    std::vector<double> a(dp.size() + 4, 0.0);   // (x^4 - 2x^2 + 1) * dp
    for (size_t i = 0; i < dp.size(); ++i) {
      a[i + 4] += dp[i];
      a[i + 2] -= 2.0 * dp[i];
      a[i] += dp[i];
    }
    std::vector<double> b(p.size() + 3, 0.0);    // (-4n x^3 + (4n-2) x) * p
    for (size_t i = 0; i < p.size(); ++i) {
      b[i + 3] += -4.0 * n * p[i];
      b[i + 1] += (4.0 * n - 2.0) * p[i];
    }
    std::vector<double> out(std::max(a.size(), b.size()), 0.0);
    for (size_t i = 0; i < a.size(); ++i) out[i] += a[i];
    for (size_t i = 0; i < b.size(); ++i) out[i] += b[i];
    while (out.size() > 1 && out.back() == 0.0) out.pop_back();
    p.swap(out);
  }
  return p;
}

// ---- multi-tone DRAG static math (mirrors ops/lowering.py) -------------

struct DragSinStatic {
  int m = 0;
  int nb = 0;                    // number of blocking tones
  double o = 0.0;
  std::vector<double> B;         // (nb+1) x 2 x 2
  std::vector<double> A;         // (nb+1) x (m+1)
  double C[2][kDragSinNC] = {};  // per-power coefficients (scaled)
  double flat[2] = {};
};

inline double& Bat(DragSinStatic& s, int i, int j, int k) {
  return s.B[(static_cast<size_t>(i) * 2 + j) * 2 + k];
}
inline double& Aat(DragSinStatic& s, int i, int p) {
  return s.A[static_cast<size_t>(i) * (s.m + 1) + p];
}

DragSinStatic drag_sin_static(double width, double delta,
                              const std::vector<double>& block,
                              bool coeff_norm) {
  DragSinStatic s;
  s.nb = static_cast<int>(block.size());
  std::vector<double> bs(s.nb);
  for (int i = 0; i < s.nb; ++i)
    bs[i] = 1.0 / M_PI / 2.0 / (block[i] - delta);
  s.m = std::max(((s.nb + 2) >> 1) << 1, 2);
  if (s.m > kDragSinMaxM) throw Unsupported{};
  s.o = M_PI / width;

  // B series: B[0] = I; for b: B[1:] += B[:-1] @ [[0, b], [-b, 0]]
  s.B.assign(static_cast<size_t>(s.nb + 1) * 4, 0.0);
  Bat(s, 0, 0, 0) = 1.0;
  Bat(s, 0, 1, 1) = 1.0;
  for (double b : bs) {
    for (int i = s.nb; i >= 1; --i) {
      // [[a00, a01], [a10, a11]] @ [[0, b], [-b, 0]]
      //   = [[-a01*b, a00*b], [-a11*b, a10*b]]
      const double a00 = Bat(s, i - 1, 0, 0), a01 = Bat(s, i - 1, 0, 1);
      const double a10 = Bat(s, i - 1, 1, 0), a11 = Bat(s, i - 1, 1, 1);
      Bat(s, i, 0, 0) += -a01 * b;
      Bat(s, i, 0, 1) += a00 * b;
      Bat(s, i, 1, 0) += -a11 * b;
      Bat(s, i, 1, 1) += a10 * b;
    }
  }

  // sin-power derivative table (sin_power_derivative_table(m, nb, o))
  const int m = s.m;
  s.A.assign(static_cast<size_t>(s.nb + 1) * (m + 1), 0.0);
  Aat(s, 0, m) = 1.0;
  for (int i = 1; i <= s.nb; ++i) {
    if (i % 2) {
      for (int p = 0; p < m; ++p)
        Aat(s, i, p) = Aat(s, i - 1, p + 1) * (p + 1) * s.o;
    } else {
      for (int p = 0; p <= m; ++p) {
        double v = 0.0;
        if (p + 2 <= m)
          v = Aat(s, i - 2, p + 2) * (p + 1) * (p + 2);
        v -= Aat(s, i - 2, p) * static_cast<double>(p) * p;
        Aat(s, i, p) = v * s.o * s.o;
      }
    }
  }

  // C[j][p] = sum_i B[i][j][0] * A[i][p]
  for (int j = 0; j < 2; ++j)
    for (int p = 0; p <= m; ++p) {
      double v = 0.0;
      for (int i = 0; i <= s.nb; ++i) v += Bat(s, i, j, 0) * Aat(s, i, p);
      s.C[j][p] = v;
    }

  double coeff = 1.0;
  if (coeff_norm) {
    double coe[2] = {0.0, 0.0};
    for (int j = 0; j < 2; ++j)
      for (int i = 0; i <= s.nb; ++i) {
        double peakA = 0.0;
        for (int p = 0; p <= m; p += 2) peakA += Aat(s, i, p);
        coe[j] += Bat(s, i, j, 0) * peakA;
      }
    coeff = std::sqrt(coe[0] * coe[0] + coe[1] * coe[1]);
  }

  for (int j = 0; j < 2; ++j) {
    double f = Bat(s, 0, j, 0);
    for (int i = 1; i <= s.nb; ++i) f += Bat(s, i, j, 0) * Aat(s, i, 0);
    s.flat[j] = f / coeff;
    for (int p = 0; p <= m; ++p) s.C[j][p] /= coeff;
  }
  return s;
}

// Gauss-Jordan inverse with partial pivoting (n <= 13)
bool invert(std::vector<double>& M, int n, std::vector<double>& inv) {
  inv.assign(static_cast<size_t>(n) * n, 0.0);
  for (int i = 0; i < n; ++i) inv[i * n + i] = 1.0;
  for (int col = 0; col < n; ++col) {
    int piv = col;
    for (int r = col + 1; r < n; ++r)
      if (std::fabs(M[r * n + col]) > std::fabs(M[piv * n + col])) piv = r;
    if (M[piv * n + col] == 0.0) return false;
    if (piv != col)
      for (int k = 0; k < n; ++k) {
        std::swap(M[piv * n + k], M[col * n + k]);
        std::swap(inv[piv * n + k], inv[col * n + k]);
      }
    const double d = M[col * n + col];
    for (int k = 0; k < n; ++k) {
      M[col * n + k] /= d;
      inv[col * n + k] /= d;
    }
    for (int r = 0; r < n; ++r) {
      if (r == col) continue;
      const double f = M[r * n + col];
      if (f == 0.0) continue;
      for (int k = 0; k < n; ++k) {
        M[r * n + k] -= f * M[col * n + k];
        inv[r * n + k] -= f * inv[col * n + k];
      }
    }
  }
  return true;
}

// edge_blend_poly (models/multy_drag.py): ASCENDING coefficients of the
// polynomial matching value/derivatives f[0..msz-1] at x (f[0] offset by 1),
// degree 2*msz - 1
std::vector<double> edge_blend_poly(const std::vector<double>& f, double x) {
  const int msz = static_cast<int>(f.size());
  std::vector<double> fff(f);
  fff[0] -= 1.0;
  std::vector<double> C(static_cast<size_t>(msz) * msz);
  for (int n = 0; n < msz; ++n)
    for (int l = 0; l < msz; ++l) {
      // x^(msz+l-n) * (msz+l)! / (msz+l-n)!
      double fac = 1.0;
      for (int t = msz + l - n + 1; t <= msz + l; ++t) fac *= t;
      C[n * msz + l] = std::pow(x, msz + l - n) * fac;
    }
  std::vector<double> Cinv;
  if (!invert(C, msz, Cinv)) throw Unsupported{};
  std::vector<double> v(msz, 0.0);
  for (int n = 0; n < msz; ++n)
    for (int l = 0; l < msz; ++l) v[n] += Cinv[n * msz + l] * fff[l];
  // descending: [flip(v), zeros(msz-1), 1]  ->  ascending:
  // [1, zeros(msz-1), v[0], v[1], ..., v[msz-1]]
  std::vector<double> asc(2 * msz, 0.0);
  asc[0] = 1.0;
  for (int i = 0; i < msz; ++i) asc[msz + i] = v[i];
  return asc;
}

// q_poly: sum_i B[i][j][0] * d^i/dx^i P, ascending coeffs scaled to sample
// units (coefficient k multiplied by dt^k), zero-padded to kDragSinxMaxQ.
// Returns the logical length (exact high-order zeros trimmed, matching
// numpy.poly1d semantics in ops/lowering.py's q_poly).
int q_poly(const DragSinStatic& s, const std::vector<double>& P_asc, int j,
           double dt, double* out /* kDragSinxMaxQ */) {
  std::vector<double> acc(P_asc.size(), 0.0);
  std::vector<double> der(P_asc);  // i-th derivative, ascending
  for (int i = 0; i <= s.nb; ++i) {
    const double w = s.B[(static_cast<size_t>(i) * 2 + j) * 2 + 0];
    for (size_t k = 0; k < der.size(); ++k) acc[k] += w * der[k];
    // differentiate ascending: der'[k] = der[k+1] * (k+1)
    for (size_t k = 0; k + 1 < der.size(); ++k)
      der[k] = der[k + 1] * (k + 1);
    if (!der.empty()) der.back() = 0.0;
  }
  if (acc.size() > kDragSinxMaxQ) throw Unsupported{};
  int len = 1;
  for (size_t k = 0; k < acc.size(); ++k)
    if (acc[k] != 0.0) len = static_cast<int>(k) + 1;
  double scale = 1.0;
  for (size_t k = 0; k < acc.size(); ++k) {
    out[k] = acc[k] * scale;
    scale *= dt;
  }
  for (size_t k = acc.size(); k < kDragSinxMaxQ; ++k) out[k] = 0.0;
  return len;
}

FactorRow lower_factor(PyObject* factor, long power, double start,
                       double dt, Emit& em) {
  if (!PyTuple_Check(factor)) throw Unsupported{};
  const Py_ssize_t nf = PyTuple_GET_SIZE(factor);
  if (nf < 2) throw Unsupported{};
  const long fun_id = as_long(PyTuple_GET_ITEM(factor, 0));
  const double shift = as_double(PyTuple_GET_ITEM(factor, nf - 1));
  // arity check: (fun_id, *args, shift).  A short tuple would read the
  // SHIFT slot as a basis argument and lower a plausible-but-wrong
  // descriptor (the Python path raises a loud unpack error); -1 = the
  // variable-arity bases validate in their own case blocks.
  auto expect_args = [&](Py_ssize_t n) {
    if (nf != n + 2) throw Unsupported{};
  };
  switch (fun_id) {
    case B_LINEAR: expect_args(0); break;
    case B_GAUSSIAN: case B_ERF: case B_COS: case B_SINC: case B_EXP:
    case B_COSH: case B_SINH: expect_args(1); break;
    case B_MOLLIFIER: case B_D_GAUSSIAN: expect_args(2); break;
    case B_EXPONENTIALCHIRP: case B_HYPERBOLICCHIRP: expect_args(3);
      break;
    case B_LINEARCHIRP: expect_args(4); break;
    case B_DRAG: expect_args(6); break;
    default: break;               // DRAG_SIN/SINX check nf themselves
  }

  FactorRow r{};
  r.power = static_cast<int32_t>(power);

  auto arg = [&](int i) {  // basis arg i (0-based, after fun_id)
    return as_double(tuple_item(factor, 1 + i));
  };
  auto plain = [&]() {
    double frac;
    split_shift((shift - start) / dt, &r.shift_hi, &frac);
    r.a[0] = static_cast<float>(frac);
    return frac;
  };

  switch (fun_id) {
    case B_LINEAR:
      plain();
      r.op = OP_LINEAR;
      r.a[1] = static_cast<float>(dt);
      break;
    case B_GAUSSIAN:
      plain();
      r.op = OP_GAUSSIAN;
      r.a[1] = static_cast<float>(dt / arg(0));
      break;
    case B_ERF:
      plain();
      r.op = OP_ERF;
      r.a[1] = static_cast<float>(dt / arg(0));
      break;
    case B_COS: {
      double frac = plain();
      r.op = OP_COS;
      const double dphi = arg(0) * dt;
      double eps, ceps;
      phase_q32(dphi, &r.q32[0], &eps);
      r.a[2] = static_cast<float>(eps);
      // descriptor v2: const phase split into turns (q32[1]) + residual
      phase_q32(-dphi * frac, &r.q32[1], &ceps);
      r.a[3] = static_cast<float>(ceps);
      break;
    }
    case B_SINC:
      plain();
      r.op = OP_SINC;
      r.a[1] = static_cast<float>(arg(0) * dt);
      break;
    case B_EXP: {
      if (PyComplex_Check(PyTuple_GET_ITEM(factor, 1))) throw Unsupported{};
      plain();
      r.op = OP_EXP;
      r.a[1] = static_cast<float>(arg(0) * dt);
      break;
    }
    case B_LINEARCHIRP: {
      double frac = plain();
      r.op = OP_LINEARCHIRP;
      const double f0 = arg(0), f1 = arg(1), T = arg(2), phi0 = arg(3);
      const double A = kTwoPi * (f1 - f0) / (2 * T) * dt * dt;
      const double B = kTwoPi * f0 * dt;
      // q32 slot order (matches FactorDesc/_quadratic_phase):
      //   [0]=dh^2, [1]=dh*dl, [2]=dl^2, [3]=linear
      double e_hh, e_hl, e_ll, e_lin;
      phase_q32(A * 4194304.0, &r.q32[0], &e_hh);       // A * 2^22
      phase_q32(A * 4096.0, &r.q32[1], &e_hl);          // A * 2^12
      phase_q32(A, &r.q32[2], &e_ll);
      phase_q32(B - 2 * A * frac, &r.q32[3], &e_lin);
      r.a[2] = static_cast<float>(e_hh);
      r.a[3] = static_cast<float>(e_hl);
      r.a[4] = static_cast<float>(e_ll);
      r.a[5] = static_cast<float>(e_lin);
      r.a[6] = static_cast<float>(
          std::fmod(std::fmod(A * frac * frac - B * frac + phi0, kTwoPi)
                    + kTwoPi, kTwoPi));
      break;
    }
    case B_EXPONENTIALCHIRP: {
      plain();
      r.op = OP_EXPCHIRP;
      const double f0 = arg(0), alpha = arg(1), phi0 = arg(2);
      if (alpha == 0.0) throw Unsupported{};  // matches lowering.py
      r.a[1] = static_cast<float>(kTwoPi * f0 / alpha);
      r.a[2] = static_cast<float>(alpha * dt);
      r.a[3] = static_cast<float>(
          std::fmod(std::fmod(phi0 - kTwoPi * f0 / alpha, kTwoPi) + kTwoPi,
                    kTwoPi));
      break;
    }
    case B_HYPERBOLICCHIRP: {
      plain();
      r.op = OP_HYPCHIRP;
      const double f0 = arg(0), k = arg(1), phi0 = arg(2);
      if (k == 0.0) throw Unsupported{};      // matches lowering.py
      r.a[1] = static_cast<float>(kTwoPi * f0 / k);
      r.a[2] = static_cast<float>(k * dt);
      r.a[3] = static_cast<float>(
          std::fmod(std::fmod(phi0, kTwoPi) + kTwoPi, kTwoPi));
      break;
    }
    case B_COSH:
      plain();
      r.op = OP_COSH;
      r.a[1] = static_cast<float>(arg(0) * dt);
      break;
    case B_SINH:
      plain();
      r.op = OP_SINH;
      r.a[1] = static_cast<float>(arg(0) * dt);
      break;
    case B_DRAG: {
      // (t0, freq, width, delta, block_freq|None, phase)
      PyObject* bf = tuple_item(factor, 5);
      const double t0 = arg(0), freq = arg(1), width = arg(2),
                   delta = arg(3), phase = arg(5);
      double frac;
      split_shift((shift + t0 - start) / dt, &r.shift_hi, &frac);
      r.a[0] = static_cast<float>(frac);
      r.op = OP_DRAG;
      const double o = M_PI / width;
      r.a[1] = static_cast<float>(o * dt);
      const double w = kTwoPi * (freq + delta);
      double eps, ceps;
      phase_q32(w * dt, &r.q32[0], &eps);
      r.a[3] = static_cast<float>(eps);
      const double phi0 = std::fmod(
          std::fmod(w * (start + static_cast<double>(r.shift_hi) * dt
                         - shift) - kTwoPi * delta * t0 - phase, kTwoPi)
          + kTwoPi, kTwoPi);
      // descriptor v2: const phase split into turns (q32[1]) + residual
      phase_q32(phi0, &r.q32[1], &ceps);
      r.a[4] = static_cast<float>(ceps);
      if (bf == Py_None) {
        r.a[5] = 0.0f;
      } else {
        const double block = as_double(bf);
        r.a[5] = (block - delta == 0.0)
            ? 0.0f
            : static_cast<float>(-o / (kTwoPi * (block - delta)));
      }
      break;
    }
    case B_D_GAUSSIAN: {
      plain();
      const double std_sq2 = arg(0);
      const long n = as_long(tuple_item(factor, 2));
      if (n > 8) throw Unsupported{};
      r.op = OP_POLY_GAUSS;
      r.a[1] = static_cast<float>(dt / std_sq2);
      r.a[2] = static_cast<float>(((n % 2) ? -1.0 : 1.0)
                                  / std::pow(std_sq2, n));
      double c[9] = {0};
      hermite_ascending(static_cast<int>(n), c);
      for (int i = 0; i <= n && i < 9; ++i)
        r.a[3 + i] = static_cast<float>(c[i]);
      break;
    }
    case B_MOLLIFIER: {
      plain();
      const double rr = arg(0);
      const long d = as_long(tuple_item(factor, 2));
      if (d > 3) throw Unsupported{};
      r.op = OP_MOLLIFIER;
      r.a[1] = static_cast<float>(dt / rr);
      r.a[2] = static_cast<float>(d);
      if (d > 0) {
        auto p = mollifier_poly_ascending(static_cast<int>(d));
        const double scale = std::pow(rr, d);
        for (size_t i = 0; i < p.size() && i < 9; ++i)
          r.a[3 + i] = static_cast<float>(p[i] / scale);
      }
      break;
    }
    case B_DRAG_SIN:
    case B_DRAG_SINX: {
      // (t0, freq, width, delta, block|None, phase, plateau[, tab])
      const bool sinx = (fun_id == B_DRAG_SINX);
      if (nf != (sinx ? 10 : 9)) throw Unsupported{};
      const double t0 = arg(0), freq = arg(1), width = arg(2),
                   delta = arg(3), phase = arg(5), plateau = arg(6);
      const double tab = sinx ? arg(7) : 0.0;
      PyObject* bf = tuple_item(factor, 5);
      std::vector<double> block;
      if (bf != Py_None) {
        if (PyFloat_Check(bf) || PyLong_Check(bf)) {
          block.push_back(as_double(bf));
        } else if (PyTuple_Check(bf)) {
          for (Py_ssize_t i = 0; i < PyTuple_GET_SIZE(bf); ++i)
            block.push_back(as_double(PyTuple_GET_ITEM(bf, i)));
        } else {
          throw Unsupported{};
        }
      }

      double frac;
      split_shift((shift + t0 - start) / dt, &r.shift_hi, &frac);
      r.a[0] = static_cast<float>(frac);
      r.op = sinx ? OP_DRAG_SINX : OP_DRAG_SIN;
      const double o = M_PI / width;
      r.a[1] = static_cast<float>(o * dt);
      const double w = kTwoPi * (freq + delta);
      double eps, ceps;
      phase_q32(w * dt, &r.q32[0], &eps);
      r.a[3] = static_cast<float>(eps);
      const double phi0 = std::fmod(
          std::fmod(w * (start + static_cast<double>(r.shift_hi) * dt
                         - shift) - kTwoPi * delta * t0 - phase, kTwoPi)
          + kTwoPi, kTwoPi);
      // descriptor v2: const phase split into turns (q32[1]) + residual
      phase_q32(phi0, &r.q32[1], &ceps);
      r.a[4] = static_cast<float>(ceps);
      r.a[5] = static_cast<float>(width / dt);
      r.a[6] = static_cast<float>(plateau / dt);

      // dedup key: all static params except the time shift
      std::vector<double> key{static_cast<double>(fun_id), width, delta,
                              tab, dt};
      key.insert(key.end(), block.begin(), block.end());
      auto it = em.ext_index.find(key);
      int64_t off, blk_len;
      if (it != em.ext_index.end()) {
        off = it->second.first;
        blk_len = it->second.second;
      } else {
        DragSinStatic s = drag_sin_static(width, delta, block, !sinx);
        off = static_cast<int64_t>(em.ext.size());
        em.ext.push_back(static_cast<double>(s.m));
        for (int j = 0; j < 2; ++j)
          for (int p = 0; p < kDragSinNC; ++p)
            em.ext.push_back(p <= s.m ? s.C[j][p] : 0.0);
        em.ext.push_back(s.flat[0]);
        em.ext.push_back(s.flat[1]);
        if (sinx) {
          em.ext.push_back(tab * width / (2 * dt));  // blend half (samples)
          for (int side = 0; side < 2; ++side) {
            const double sign = side == 0 ? -1.0 : 1.0;
            // edge rows at x = (1 + sign*tab) * width/2
            const double xa = s.o * (1.0 + sign * tab) * width / 2.0;
            std::vector<double> base(s.m + 1);
            for (int p = 0; p <= s.m; ++p) {
              base[p] = std::pow(std::sin(xa), p);
              if (p % 2) base[p] *= std::cos(xa);
            }
            std::vector<double> eA(s.nb + 1, 0.0);
            for (int i = 0; i <= s.nb; ++i)
              for (int p = 0; p <= s.m; ++p)
                eA[i] += Aat(s, i, p) * base[p];
            auto P = edge_blend_poly(eA, sign * tab * width / 2.0);
            double q[kDragSinxMaxQ];
            for (int j = 0; j < 2; ++j) {
              const int qlen = q_poly(s, P, j, dt, q);
              em.ext.push_back(static_cast<double>(qlen));
              for (int k = 0; k < kDragSinxMaxQ; ++k) em.ext.push_back(q[k]);
            }
          }
        }
        blk_len = static_cast<int64_t>(em.ext.size()) - off;
        em.ext_index.emplace(std::move(key), std::make_pair(off, blk_len));
      }
      r.a[7] = static_cast<float>(off);
      // the block's OWN length, not the buffer tail: a dedup hit after
      // other blocks were appended must restore the original span
      // (the tail length defeated dedup downstream)
      r.a[8] = static_cast<float>(blk_len);
      break;
    }
    default:
      throw Unsupported{};
  }
  return r;
}

// np.searchsorted(grid, b, side='left') over the f64 grid
int64_t searchsorted(const double* grid, int64_t n, double b) {
  // NaN sorts LAST in numpy; grid[mid] < NaN is always false and would
  // otherwise collapse the window to 0, silently mis-windowing every
  // later segment
  if (std::isnan(b)) return n;
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (grid[mid] < b) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Lower one channel's pieces into Emit; throws Unsupported for fallback.
void lower_pieces(PyObject* pieces, const double* grid, int64_t n_grid,
                  double start, double dt, int want_imag, Emit* out) {
  if (!PyList_Check(pieces) && !PyTuple_Check(pieces)) throw Unsupported{};
  const Py_ssize_t n_pieces = PyList_Check(pieces)
      ? PyList_GET_SIZE(pieces) : PyTuple_GET_SIZE(pieces);
  for (Py_ssize_t pi = 0; pi < n_pieces; ++pi) {
    PyObject* piece = PyList_Check(pieces)
        ? PyList_GET_ITEM(pieces, pi) : PyTuple_GET_ITEM(pieces, pi);
    PyObject* bounds = tuple_item(piece, 0);
    PyObject* seq = tuple_item(piece, 1);
    const Py_ssize_t nseg = tuple_size(bounds);
    if (tuple_size(seq) != nseg) throw Unsupported{};
    int64_t lo = 0;
    for (Py_ssize_t si = 0; si < nseg; ++si) {
      const double b = as_double(tuple_item(bounds, si));
      const int64_t hi = std::isinf(b) && b > 0
          ? n_grid : searchsorted(grid, n_grid, b);
      PyObject* expr = tuple_item(seq, si);
      PyObject* terms = tuple_item(expr, 0);
      PyObject* amps = tuple_item(expr, 1);
      const Py_ssize_t nterm = tuple_size(terms);
      if (tuple_size(amps) != nterm) throw Unsupported{};
      if (lo < hi && nterm > 0) {
        int32_t emitted_terms = 0;
        for (Py_ssize_t ti = 0; ti < nterm; ++ti) {
          PyObject* amp_o = tuple_item(amps, ti);
          Py_complex av;
          if (PyComplex_Check(amp_o)) {
            av = PyComplex_AsCComplex(amp_o);
          } else {
            av.real = as_double(amp_o);
            av.imag = 0.0;
          }
          const double amp = want_imag ? av.imag : av.real;
          if (amp == 0.0) continue;
          PyObject* term = tuple_item(terms, ti);
          PyObject* factors = tuple_item(term, 0);
          PyObject* powers = tuple_item(term, 1);
          const Py_ssize_t nfac = tuple_size(factors);
          if (tuple_size(powers) != nfac) throw Unsupported{};
          out->term_amp.push_back(to_f32(amp));
          out->term_nfac.push_back(static_cast<int32_t>(nfac));
          ++emitted_terms;
          for (Py_ssize_t fi2 = 0; fi2 < nfac; ++fi2) {
            PyObject* pw = PyTuple_GET_ITEM(powers, fi2);
            double pw_d = as_double(pw);
            long pw_l = static_cast<long>(pw_d);
            if (pw_d != static_cast<double>(pw_l)) throw Unsupported{};
            if (pw_l == 0) throw Unsupported{};  // matches lowering.py
            out->facs.push_back(lower_factor(
                PyTuple_GET_ITEM(factors, fi2), pw_l, start, dt, *out));
          }
        }
        if (emitted_terms > 0) {
          out->seg_lo.push_back(lo);
          out->seg_hi.push_back(hi);
          out->seg_nterm.push_back(emitted_terms);
        }
        // (emitted_terms == 0: nothing was pushed, nothing to roll back)
      }
      lo = hi;
    }
  }
}

PyObject* bytes_from(const void* data, size_t nbytes) {
  return PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(data), nbytes);
}

PyObject* py_lower_channel(PyObject*, PyObject* args) {
  PyObject* pieces;
  Py_buffer gridbuf;
  double start, dt;
  int want_imag;
  if (!PyArg_ParseTuple(args, "Oy*ddi", &pieces, &gridbuf, &start, &dt,
                        &want_imag))
    return nullptr;
  const double* grid = reinterpret_cast<const double*>(gridbuf.buf);
  const int64_t n_grid = gridbuf.len / 8;

  Emit out;
  bool ok = true;
  try {
    lower_pieces(pieces, grid, n_grid, start, dt, want_imag, &out);
  } catch (Unsupported&) {
    ok = false;
    PyErr_Clear();   // Unsupported == intentional Python-path fallback
  }
  PyBuffer_Release(&gridbuf);
  if (PyErr_Occurred()) return nullptr;
  if (!ok) Py_RETURN_NONE;

  // pack factor rows into parallel byte buffers
  const size_t nf = out.facs.size();
  std::vector<int32_t> f_op(nf), f_pw(nf), f_sh(nf);
  std::vector<int32_t> f_q32(nf * 4);
  std::vector<float> f_args(nf * W_ARGS);
  for (size_t i = 0; i < nf; ++i) {
    const FactorRow& r = out.facs[i];
    f_op[i] = r.op;
    f_pw[i] = r.power;
    f_sh[i] = r.shift_hi;
    std::memcpy(&f_q32[i * 4], r.q32, sizeof(r.q32));
    std::memcpy(&f_args[i * W_ARGS], r.a, sizeof(r.a));
  }
  return Py_BuildValue(
      "(NNN)(NN)(NNNNN)N",
      bytes_from(out.seg_lo.data(), out.seg_lo.size() * 8),
      bytes_from(out.seg_hi.data(), out.seg_hi.size() * 8),
      bytes_from(out.seg_nterm.data(), out.seg_nterm.size() * 4),
      bytes_from(out.term_amp.data(), out.term_amp.size() * 4),
      bytes_from(out.term_nfac.data(), out.term_nfac.size() * 4),
      bytes_from(f_op.data(), nf * 4),
      bytes_from(f_pw.data(), nf * 4),
      bytes_from(f_sh.data(), nf * 4),
      bytes_from(f_q32.data(), nf * 16),
      bytes_from(f_args.data(), nf * W_ARGS * 4),
      bytes_from(out.ext.data(), out.ext.size() * 8));
}

PyMethodDef methods[] = {
    {"lower_channel", py_lower_channel, METH_VARARGS,
     "Lower one channel's (bounds, seq) pieces to flat descriptors; "
     "returns None when a factor needs the Python path."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_lowerext",
    "native IR -> descriptor lowering", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

extern "C" PyMODINIT_FUNC PyInit__lowerext(void) {
  return PyModule_Create(&moduledef);
}
