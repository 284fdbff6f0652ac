// wavecore: native CPU synthesis engine over flat waveform descriptors.
//
// Consumes the exact descriptor layout produced by
// waveforms_tpu_torch/ops/lowering.py (the same tensors the Pallas TPU kernel
// interprets) and synthesizes multi-channel sample buffers in double
// precision, multithreaded over channels.  This is the production host
// path -- the role the reference library gave its compiled Cython core and
// its unbuilt C engine (feihoo87/waveforms/waveforms/_waveform.pyx,
// feihoo87/waveforms/src/waveform.c) -- with the same int32 fixed-point phase
// accumulators as the TPU kernel, evaluated here at f64 so it doubles as a
// high-precision oracle for kernel semantics.
//
// Zero-segment skipping is structural: iteration is per segment over its
// own clipped sample range, so silence costs nothing (only the initial
// memset).
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC (see native/__init__.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <limits>

#if defined(_OPENMP)
#include <omp.h>
#endif
#if defined(__SSE__) || defined(__x86_64__)
#include <xmmintrin.h>
#include <pmmintrin.h>
#define WAVECORE_HAVE_MXCSR 1
#endif

namespace {

// infinity test by bit pattern: immune to -ffinite-math-only, under
// which the compiler folds std::isinf(x) to false
inline bool bits_inf(double x) {
  uint64_t u;
  std::memcpy(&u, &x, sizeof u);
  return (u & 0x7FFFFFFFFFFFFFFFull) == 0x7FF0000000000000ull;
}
// Scoped FTZ/DAZ: flush-to-zero makes denormal-heavy tails (gaussian,
// exp) run at full speed, but must NOT leak into the host process the way
// crtfastmath.o would -- save and restore per call (and per OpenMP thread).
struct ScopedFlushToZero {
#if defined(WAVECORE_HAVE_MXCSR)
  unsigned int saved;
  ScopedFlushToZero() : saved(_mm_getcsr()) {
    _mm_setcsr(saved | 0x8040);  // FTZ | DAZ
  }
  ~ScopedFlushToZero() { _mm_setcsr(saved); }
#endif
};
}  // namespace

namespace {

constexpr double kTwoPi = 6.283185307179586476925286766559;
constexpr double kPhaseScale = kTwoPi / 4294967296.0;  // turn/2^32 -> rad

// Opcodes: keep in sync with waveforms_tpu_torch/ops/lowering.py.
enum Op : int32_t {
  OP_LINEAR = 0,
  OP_GAUSSIAN = 1,
  OP_ERF = 2,
  OP_COS = 3,
  OP_SINC = 4,
  OP_EXP = 5,
  OP_LINEARCHIRP = 6,
  OP_EXPCHIRP = 7,
  OP_HYPCHIRP = 8,
  OP_COSH = 9,
  OP_SINH = 10,
  OP_DRAG = 11,
  OP_POLY_GAUSS = 12,
  OP_MOLLIFIER = 13,
  // extended opcodes: read the float64 ext side-buffer
  OP_INTERP = 14,
  OP_DRAG_SIN = 15,
  OP_DRAG_SINX = 16,
};

struct Factor {
  int32_t op;
  int32_t power;
  int32_t shift_hi;
  const int32_t* q32;   // 4 fixed-point phase increments
  const float* a;       // W args
  const double* ext;    // float64 side-buffer (whole schedule)
};

inline double polyval_ascending_d(const double* c, int count, double x) {
  double acc = 0.0;
  for (int k = count - 1; k >= 0; --k) acc = acc * x + c[k];
  return acc;
}

inline double carrier_phase(int64_t di64, int32_t q32, double eps,
                            double cst) {
  // int32 wraparound multiplication == exact phase mod 2^32 (mod 2 pi)
  int32_t di = static_cast<int32_t>(di64);
  int32_t turns = static_cast<int32_t>(
      static_cast<uint32_t>(q32) * static_cast<uint32_t>(di));
  return turns * kPhaseScale + eps * di + cst;
}

inline double quadratic_phase(int64_t di64, const int32_t* q,
                              const float* a) {
  int32_t di = static_cast<int32_t>(di64);
  int32_t dh = di >> 11;
  int32_t dl = di - (dh << 11);
  uint32_t turns = static_cast<uint32_t>(q[0]) * dh * dh +
                   static_cast<uint32_t>(q[1]) * dh * dl +
                   static_cast<uint32_t>(q[2]) * dl * dl +
                   static_cast<uint32_t>(q[3]) * di;
  double resid = (static_cast<double>(a[2]) * dh +
                  static_cast<double>(a[3]) * dl) * dh +
                 static_cast<double>(a[4]) * dl * dl +
                 static_cast<double>(a[5]) * di;
  return static_cast<int32_t>(turns) * kPhaseScale + resid + a[6];
}

inline double polyval_ascending(const float* c, int count, double x) {
  double acc = 0.0;
  for (int k = count - 1; k >= 0; --k) acc = acc * x + c[k];
  return acc;
}

// Evaluate one factor over the sample block [idx0, idx0+n) into buf.
// The opcode branch happens once per block; the inner loops are tight and
// auto-vectorize under -O3 -ffast-math -march=native (libmvec sin/cos/exp).
void eval_factor_block(const Factor& f, int64_t idx0, int n, double* buf) {
  const int64_t di0 = idx0 - f.shift_hi;
  const double frac = f.a[0];
  switch (f.op) {
    case OP_LINEAR: {
      const double a1 = f.a[1];
#pragma omp simd
      for (int i = 0; i < n; ++i) buf[i] = a1 * (di0 + i - frac);
      break;
    }
    case OP_GAUSSIAN: {
      const double a1 = f.a[1];
#pragma omp simd
      for (int i = 0; i < n; ++i) {
        double x = a1 * (di0 + i - frac);
        buf[i] = std::exp(-(x * x));
      }
      break;
    }
    case OP_ERF: {
      const double a1 = f.a[1];
      for (int i = 0; i < n; ++i) buf[i] = std::erf(a1 * (di0 + i - frac));
      break;
    }
    case OP_COS: {
      // const phase = int32 turns in q32[1] + f32 residual in a[3]
      // (descriptor format v2, cf. lowering._lower_factor)
      const int32_t q = f.q32[0], cq = f.q32[1];
      const double eps = f.a[2], cst = f.a[3];
      const int32_t d0 = static_cast<int32_t>(di0);
#pragma omp simd
      for (int i = 0; i < n; ++i) {
        int32_t di = d0 + i;
        int32_t turns = static_cast<int32_t>(
            static_cast<uint32_t>(q) * static_cast<uint32_t>(di) +
            static_cast<uint32_t>(cq));
        buf[i] = std::cos(turns * kPhaseScale + eps * di + cst);
      }
      break;
    }
    case OP_SINC: {
      const double a1 = f.a[1];
      for (int i = 0; i < n; ++i) {
        double x = M_PI * (a1 * (di0 + i - frac));
        buf[i] = (std::fabs(x) < 1e-12) ? 1.0 : std::sin(x) / x;
      }
      break;
    }
    case OP_EXP: {
      const double a1 = f.a[1];
#pragma omp simd
      for (int i = 0; i < n; ++i)
        buf[i] = std::exp(a1 * (di0 + i - frac));
      break;
    }
    case OP_LINEARCHIRP: {
#pragma omp simd
      for (int i = 0; i < n; ++i)
        buf[i] = std::sin(quadratic_phase(di0 + i, f.q32, f.a));
      break;
    }
    case OP_EXPCHIRP: {
      const double a1 = f.a[1], a2 = f.a[2], a3 = f.a[3];
      for (int i = 0; i < n; ++i)
        buf[i] = std::sin(a3 + a1 * std::exp(a2 * (di0 + i - frac)));
      break;
    }
    case OP_HYPCHIRP: {
      const double a1 = f.a[1], a2 = f.a[2], a3 = f.a[3];
      for (int i = 0; i < n; ++i)
        // clamp matches the Pallas kernel's 1e-30 (pallas_synth.py):
        // this engine's role is a high-precision oracle for KERNEL
        // semantics (the numpy oracle keeps the reference's NaNs)
        buf[i] = std::sin(a3 + a1 * std::log(std::max(
            1.0 + a2 * (di0 + i - frac), 1e-30)));
      break;
    }
    case OP_COSH: {
      const double a1 = f.a[1];
      for (int i = 0; i < n; ++i)
        buf[i] = std::cosh(a1 * (di0 + i - frac));
      break;
    }
    case OP_SINH: {
      const double a1 = f.a[1];
      for (int i = 0; i < n; ++i)
        buf[i] = std::sinh(a1 * (di0 + i - frac));
      break;
    }
    case OP_DRAG: {
      const double a1 = f.a[1];
      const int32_t q = f.q32[0], cq = f.q32[1];
      const double eps = f.a[3], cst = f.a[4], b = f.a[5];
      const int32_t d0 = static_cast<int32_t>(di0);
#pragma omp simd
      for (int i = 0; i < n; ++i) {
        double x = a1 * (d0 + i - frac);
        double s = std::sin(x);
        int32_t di = d0 + i;
        int32_t turns = static_cast<int32_t>(
            static_cast<uint32_t>(q) * static_cast<uint32_t>(di) +
            static_cast<uint32_t>(cq));
        double theta = turns * kPhaseScale + eps * di + cst;
        buf[i] = s * s * std::cos(theta) +
                 b * std::sin(2.0 * x) * std::sin(theta);
      }
      break;
    }
    case OP_POLY_GAUSS: {
      const double a1 = f.a[1], a2 = f.a[2];
      for (int i = 0; i < n; ++i) {
        double x = a1 * (di0 + i - frac);
        buf[i] = a2 * polyval_ascending(f.a + 3, 9, x) * std::exp(-(x * x));
      }
      break;
    }
    case OP_MOLLIFIER: {
      const double a1 = f.a[1], d = f.a[2];
      for (int i = 0; i < n; ++i) {
        double x = a1 * (di0 + i - frac);
        double xx1 = x * x - 1.0;
        if (xx1 >= 0.0) {
          buf[i] = 0.0;
        } else {
          double bump = std::exp(1.0 / xx1 + 1.0);
          buf[i] = (d > 0.0)
              ? bump / std::pow(-xx1, 2.0 * d) *
                    polyval_ascending(f.a + 3, 9, x)
              : bump;
        }
      }
      break;
    }
    case OP_INTERP: {
      const double a1 = f.a[1], a2 = f.a[2];
      const double* tab = f.ext + static_cast<int64_t>(f.a[7]);
      const int np = static_cast<int>(f.a[8]);
      if (np < 2) {  // degenerate table: constant fill, no tab[-1] read
        const double v = np == 1 ? tab[0] : 0.0;
        for (int i = 0; i < n; ++i) buf[i] = v;
        break;
      }
      for (int i = 0; i < n; ++i) {
        double pos = a1 * (di0 + i - frac) + a2;
        pos = std::min(std::max(pos, 0.0), static_cast<double>(np - 1));
        int i0 = static_cast<int>(pos);
        if (i0 >= np - 1) i0 = np - 2;
        double w = pos - i0;
        buf[i] = tab[i0] * (1.0 - w) + tab[i0 + 1] * w;
      }
      break;
    }
    case OP_DRAG_SIN:
    case OP_DRAG_SINX: {
      // fixed-layout ext block (see lowering.py):
      //   [m, cx[0..MAXM], cy[0..MAXM], flat_x, flat_y,
      //    (sinx: blend_half, {len, coeffs[MAXQ]} x4)]
      constexpr int kNC = 13;   // DRAG_SIN_NC
      constexpr int kMQ = 40;   // DRAG_SINX_MAXQ
      const double* e = f.ext + static_cast<int64_t>(f.a[7]);
      const int m = static_cast<int>(e[0]);
      const double* cx = e + 1;
      const double* cy = cx + kNC;
      const double flat_x = cy[kNC];
      const double flat_y = cy[kNC + 1];
      const double o_dt = f.a[1];
      const double eps = f.a[3], cst = f.a[4];
      const double w_samp = f.a[5], p_samp = f.a[6];
      const int32_t q = f.q32[0], cq = f.q32[1];
      const int32_t d0 = static_cast<int32_t>(di0);

      double blend_half = 0.0;
      const double *lx = nullptr, *ly = nullptr, *rx = nullptr,
                   *ry = nullptr;
      int lx_n = 0, ly_n = 0, rx_n = 0, ry_n = 0;
      if (f.op == OP_DRAG_SINX) {
        const double* p = cy + kNC + 2;
        blend_half = p[0];
        ++p;
        lx_n = static_cast<int>(p[0]); lx = p + 1; p = lx + kMQ;
        ly_n = static_cast<int>(p[0]); ly = p + 1; p = ly + kMQ;
        rx_n = static_cast<int>(p[0]); rx = p + 1; p = rx + kMQ;
        ry_n = static_cast<int>(p[0]); ry = p + 1;
      }
      const double left_hi = w_samp / 2;
      const double right_lo = w_samp / 2 + p_samp;
      // NB: the reference's plateau construction is *discontinuous* at
      // t0 + width/2 (the flat override replaces only row 0); a sample
      // landing exactly on that edge classifies by floating-point
      // tie-break, so a grid point coinciding with the edge may take
      // either side (sub-sample descriptor quantization ~1e-7 samples).
      const double kEdge = 0.0;

      for (int i = 0; i < n; ++i) {
        const double u = d0 + i - frac;      // samples since t0'
        double ox, oy;
        if (lx && u >= left_hi - blend_half && u <= left_hi) {
          const double x = u - left_hi;
          ox = polyval_ascending_d(lx, lx_n, x);
          oy = polyval_ascending_d(ly, ly_n, x);
        } else if (rx && u >= right_lo && u <= right_lo + blend_half) {
          const double x = u - right_lo;
          ox = polyval_ascending_d(rx, rx_n, x);
          oy = polyval_ascending_d(ry, ry_n, x);
        } else if (u > left_hi + kEdge && u < right_lo - kEdge) {
          ox = flat_x;
          oy = flat_y;
        } else {
          const double bt = (u <= left_hi + kEdge) ? u : u - p_samp;
          const double s = std::sin(o_dt * bt);
          const double c = std::cos(o_dt * bt);
          double sp = 1.0;                   // s^p
          ox = 0.0; oy = 0.0;
          for (int pp = 0; pp <= m; ++pp) {
            const double basis = (pp & 1) ? sp * c : sp;
            ox += cx[pp] * basis;
            oy += cy[pp] * basis;
            sp *= s;
          }
        }
        const int32_t di = d0 + i;
        const int32_t turns = static_cast<int32_t>(
            static_cast<uint32_t>(q) * static_cast<uint32_t>(di) +
            static_cast<uint32_t>(cq));
        const double theta = turns * kPhaseScale + eps * di + cst;
        buf[i] = ox * std::cos(theta) + oy * std::sin(theta);
      }
      break;
    }
    default:
      for (int i = 0; i < n; ++i) buf[i] = 0.0;
  }
  if (f.power == 0) {          // x**0 == 1, matching the other engines
    for (int i = 0; i < n; ++i) buf[i] = 1.0;
  } else if (f.power != 1) {
    const int p = f.power < 0 ? -f.power : f.power;
    const bool inv = f.power < 0;
    for (int i = 0; i < n; ++i) {
      double v = buf[i], acc = v;
      for (int k = 1; k < p; ++k) acc *= v;
      buf[i] = inv ? 1.0 / acc : acc;
    }
  }
}

}  // namespace

extern "C" {

// Synthesize all channels into out[C * n_samples] (double, zero-initialized
// here).  Descriptor arrays use the (C, NB, Sb, T, F, W) flattened layout of
// waveforms_tpu_torch.ops.lowering.LoweredSchedule.  When amp_im/out_im are
// non-null (pair mode, part='complex' schedules), each term's factor
// product is computed once and scaled by both amplitude planes into the
// two outputs -- the CPU analog of the Pallas kernel's pair mode.
void wavecore_synthesize(const int32_t* seg_lo, const int32_t* seg_hi,
                         const int32_t* nterm, const int32_t* nfac,
                         const float* amp, const int32_t* op,
                         const int32_t* power, const int32_t* shift_hi,
                         const int32_t* q32, const float* args,
                         const double* ext,
                         const float* clip, int32_t C, int32_t NB,
                         int32_t Sb, int32_t T, int32_t F, int32_t W,
                         int64_t n_samples, int64_t bucket_samples,
                         double* out, const float* amp_im, double* out_im,
                         int32_t n_threads) {
  const bool pair = amp_im != nullptr && out_im != nullptr;
#if defined(_OPENMP)
  // per-region clause, NOT omp_set_num_threads: the global setter
  // leaks into later calls (n_threads=0 then never restored the
  // all-cores default) and into other OpenMP users in the process
  const int nt = n_threads > 0 ? n_threads : omp_get_num_procs();
#endif
  // Buckets write disjoint sample windows (segments are clipped to their
  // bucket), so (channel x bucket) parallelism scales even for
  // single-channel schedules on many-core hosts.
  const int64_t total = static_cast<int64_t>(C) * n_samples;
  // small schedules: OpenMP spawn + parallel memset cost more than the
  // whole synthesis -- run serial below ~1M samples
  const bool small = total < (1 << 20);
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) if (!small) num_threads(nt)
#endif
  for (int64_t i = 0; i < static_cast<int64_t>(C) * n_samples; i += 65536) {
    const int64_t n = std::min<int64_t>(65536, C * n_samples - i);
    std::memset(out + i, 0, sizeof(double) * n);
    if (pair) std::memset(out_im + i, 0, sizeof(double) * n);
  }
#if defined(_OPENMP)
#pragma omp parallel for collapse(2) schedule(dynamic, 1) if (!small) \
    num_threads(nt)
#endif
  for (int32_t c = 0; c < C; ++c) {
    for (int32_t b = 0; b < NB; ++b) {
      ScopedFlushToZero ftz;
      double* ch = out + static_cast<int64_t>(c) * n_samples;
      double* chi = pair ? out_im + static_cast<int64_t>(c) * n_samples
                         : nullptr;
      const double cmin = clip[2 * c];
      const double cmax = clip[2 * c + 1];
      // bit test, not std::isinf: -ffinite-math-only folds isinf to
      // false, which made EVERY channel pay the clamp pass
      const bool has_clip = !(bits_inf(cmin) && bits_inf(cmax));
      const int64_t bucket_lo = static_cast<int64_t>(b) * bucket_samples;
      const int64_t bucket_hi =
          std::min<int64_t>(bucket_lo + bucket_samples, n_samples);
      bool poisoned = false;
      const int64_t seg_base = (static_cast<int64_t>(c) * NB + b) * Sb;
      for (int32_t s = 0; s < Sb; ++s) {
        const int64_t si = seg_base + s;
        const int32_t nt = nterm[si];
        if (nt == 0) continue;
        const int64_t lo = std::max<int64_t>(seg_lo[si], bucket_lo);
        const int64_t hi = std::min<int64_t>(seg_hi[si], bucket_hi);
        if (lo >= hi) continue;

        for (int32_t t = 0; t < nt; ++t) {
          const int64_t ti = si * T + t;
          const double a0 = amp[ti];
          const double a0i = pair ? amp_im[ti] : 0.0;
          const int32_t nf = nfac[ti];
          // F is host-padded and lower_schedule enforces F <= 32; a
          // hand-built descriptor above that must fail LOUDLY (NaN),
          // never silently drop factors
          constexpr int kMaxFac = 32;
          Factor facs[kMaxFac];
          if (nf > kMaxFac) {
            poisoned = true;
            continue;
          }
          const int n_use = nf;
          for (int f = 0; f < n_use; ++f) {
            const int64_t fi = ti * F + f;
            facs[f] = Factor{op[fi], power[fi], shift_hi[fi],
                             q32 + fi * 4, args + fi * W, ext};
          }
          constexpr int kBlock = 1024;
          double prod[kBlock], fbuf[kBlock];
          for (int64_t blk = lo; blk < hi; blk += kBlock) {
            const int n = static_cast<int>(std::min<int64_t>(kBlock,
                                                             hi - blk));
#pragma omp simd
            for (int i = 0; i < n; ++i) prod[i] = pair ? 1.0 : a0;
            for (int f = 0; f < n_use; ++f) {
              eval_factor_block(facs[f], blk, n, fbuf);
#pragma omp simd
              for (int i = 0; i < n; ++i) prod[i] *= fbuf[i];
            }
            if (pair) {
#pragma omp simd
              for (int i = 0; i < n; ++i) {
                ch[blk + i] += a0 * prod[i];
                chi[blk + i] += a0i * prod[i];
              }
            } else {
#pragma omp simd
              for (int i = 0; i < n; ++i) ch[blk + i] += prod[i];
            }
          }
        }
        if (has_clip) {
          // Clip the segment's accumulated value in place; clipped channels
          // are single piecewise waveforms, so segments never overlap and
          // samples outside any segment stay exactly zero (oracle
          // semantics: clip applies per non-zero part only).
          for (int64_t i = lo; i < hi; ++i)
            ch[i] = std::min(std::max(ch[i], cmin), cmax);
          if (pair)
            for (int64_t i = lo; i < hi; ++i)
              chi[i] = std::min(std::max(chi[i], cmin), cmax);
        }
      }
      if (poisoned) {
        // fail LOUDLY: bit-pattern NaN stores AFTER the clip pass --
        // -ffast-math min/max would otherwise launder an in-loop NaN
        // into a plausible clipped value, and the imag plane must
        // poison too
        uint64_t nan_bits = 0x7FF8000000000000ull;
        double nan_v;
        std::memcpy(&nan_v, &nan_bits, sizeof nan_v);
        for (int64_t i = bucket_lo; i < bucket_hi; ++i) ch[i] = nan_v;
        if (pair)
          for (int64_t i = bucket_lo; i < bucket_hi; ++i) chi[i] = nan_v;
      }
    }
  }
}

int32_t wavecore_version() { return 3; }

}  // extern "C"
