"""The plain model of S1's blocked scan (``reference_iir.df2t_blocked``) on
the CPU.

The kernel ``csrc/iir_df2t.cu`` cuts each row into chunks and carries the
state across them in double-double (float64 for an f32 signal); the model
runs the same operations in the same order, and the card tests
(``tests/test_torch_cuda.py``) hold the kernel to it bit for bit.  Here the
model is held to the function's contract, on butter(5, 0.15), the
near-unit double pole (r = 1 - 1e-8) and the clustered three-pole filter,
in float64 and float32, from random non-zero states:

- over each row's first chunk it equals the plain sequential version
  ``df2t`` bit for bit, and throughout where a row is one chunk;
- the carry matrix Phi = A^L equals L exact zero-input steps from each unit
  state (``fractions.Fraction``) within 1e-20 of its largest entry;
- its distance to the answer of scipy's ``lfilter`` in ``np.longdouble``
  (80-bit on x86) is at most twice ``df2t``'s, or 1e-13 (1e-6 in float32)
  where that is larger.  A distance is chip_smoke.py's ``rows_err``, the
  largest over the rows of max|out - truth| / max|truth|, over each row's
  outputs and final state; rows on which ``df2t`` is not finite (float32
  on a diverging filter) are left out.  The blocked output is not the
  sequential one beyond the first chunk: the clustered direct form
  amplifies rounding by ~1e10, and the carry is more precise than the
  sequential recurrence.  Row by row the two errors are random walks of
  one size on rows of a few chunks, so a row's ratio can exceed 2 where
  the rows' largest does not;
- in float64 on the clustered filter, within 1e-5 of scipy's float64
  ``lfilter`` of the peak (the JAX suite's bound, tests/test_ops_iir_fft.py);
- the same on a pulse-train row of 2^20 samples at the kernel's chunk
  ``CHUNK``, where scipy's float64 ``lfilter`` stands for ``df2t`` (the two
  are equal bit for bit, tests/test_torch_signal.py).

The grid runs at a chunk of 64 samples so that 100 chunks stay a short
sequential reference; from 34 chunks on, the carry runs in two levels
(groups of ``CARRY_GROUP`` steps).  The 2^20-sample row runs at
``CHUNK``.
"""

import fractions

import numpy as np
import pytest
import scipy.signal as sps
import torch

from waveforms_tpu_torch.ops import iir_cases, reference_iir

GRID_CHUNK = 64
LENGTHS = (40, GRID_CHUNK, GRID_CHUNK + 1, 1000, 64 * GRID_CHUNK,
           100 * GRID_CHUNK + 7)
FLOOR = {torch.float64: 1e-13, torch.float32: 1e-6}
TOL_SCIPY = 1e-5
TOL_PHI = 1e-20
LD = np.longdouble


def _coef(name, dtype):
    """The normalised coefficients in ``dtype`` -> (coef, b, a), b and a
    float64 arrays of the values ``dtype`` holds."""
    coef = iir_cases.coefficients(*iir_cases.filters()[name], dtype)
    c = coef.double().numpy()
    return coef, c[:len(c) // 2], c[len(c) // 2:]


def _run(fn, x, coef, zi, **kw):
    y, zf = torch.empty_like(x), torch.empty_like(zi)
    fn(x, coef, zi, y, zf, **kw)
    return y, zf


def _longdouble(b, a, x, zi):
    """scipy's lfilter in np.longdouble, row by row -> (y, zf)."""
    out = [sps.lfilter(b.astype(LD), a.astype(LD), xr.astype(LD),
                       zi=zr.astype(LD)) for xr, zr in zip(x, zi)]
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


def _distance(got, truth):
    """max over rows of max|got - truth| / max|truth| (chip_smoke.py's
    rows_err)."""
    return max(float(np.abs(g.astype(LD) - t).max() / np.abs(t).max())
               for g, t in zip(got, truth))


def _no_farther(got, ref, truth, floor):
    """_distance(got) <= max(2 _distance(ref), floor) over the rows where
    ``ref`` is finite -> (ok, the rows left out)."""
    keep = [r for r, f in enumerate(ref) if np.isfinite(f).all()]
    if not keep:
        return True, list(range(len(ref)))
    d_got = _distance(got[keep], truth[keep])
    d_ref = _distance(ref[keep], truth[keep])
    return d_got <= max(2 * d_ref, floor), sorted(set(range(len(ref)))
                                                  - set(keep))


@pytest.mark.parametrize('n', LENGTHS)
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('name', list(iir_cases.filters()))
def test_blocked_model_meets_the_contract(name, dtype, n):
    coef, b, a = _coef(name, dtype)
    d = len(a) - 1
    rng = np.random.default_rng(31)
    x = torch.tensor(rng.standard_normal((3, n)), dtype=dtype)
    zi = torch.tensor(rng.standard_normal((3, d)) * 0.01, dtype=dtype)
    y, zf = _run(reference_iir.df2t_blocked, x, coef, zi, chunk=GRID_CHUNK)
    ys, zfs = _run(reference_iir.df2t, x, coef, zi)
    assert torch.equal(y[:, :GRID_CHUNK], ys[:, :GRID_CHUNK])
    if n <= GRID_CHUNK:
        assert torch.equal(y, ys) and torch.equal(zf, zfs)
        return
    xs, zs = x.double().numpy(), zi.double().numpy()
    # each row's outputs and its final state, taken together
    ok, skipped = _no_farther(torch.cat([y, zf], 1).double().numpy(),
                          torch.cat([ys, zfs], 1).double().numpy(),
                          np.concatenate(_longdouble(b, a, xs, zs), 1),
                          FLOOR[dtype])
    assert ok
    # an f32 row left out is one on which the sequential f32 recurrence
    # itself is not finite
    assert dtype == torch.float32 or not skipped
    if dtype == torch.float64 and name == 'clustered':
        ref = sps.lfilter(b, a, xs, zi=zs)[0]
        err = np.abs(y.numpy() - ref).max(1) / np.abs(ref).max(1)
        assert err.max() <= TOL_SCIPY


def _exact_phi(b, a, L):
    """Phi = A^L by L exact zero-input steps of the recurrence from each
    unit state, in fractions.Fraction -> (d, d) nested lists."""
    d = len(a) - 1
    af = [fractions.Fraction(v) for v in a[1:]]
    bf0 = fractions.Fraction(b[0]) * 0          # the zero input's b0 x
    cols = []
    for j in range(d):
        s = [fractions.Fraction(int(i == j)) for i in range(d)]
        for _ in range(L):
            yn = bf0 + s[0]
            s = [(s[i + 1] if i + 1 < d else 0) - af[i] * yn
                 for i in range(d)]
        cols.append(s)
    return [[cols[j][i] for j in range(d)] for i in range(d)]


@pytest.mark.parametrize('name', list(iir_cases.filters()))
def test_carry_matrix_is_exact_to_double_double(name):
    """Phi from the model's L double-double steps from each unit state,
    held to the exact steps at L = 64 within 1e-20 of its largest entry;
    an f32 signal's, in plain float64, within 1e-12."""
    L = 64
    for dtype, tol in ((torch.float64, TOL_PHI), (torch.float32, 1e-12)):
        coef, b, a = _coef(name, dtype)
        phi = reference_iir.carry_matrix(coef, L)
        hi, lo = phi if dtype == torch.float64 else (phi, 0 * phi)
        exact = _exact_phi(b, a, L)
        d = len(a) - 1
        big = max(abs(v) for row in exact for v in row)
        worst = max(abs(fractions.Fraction(float(hi[i, j]))
                        + fractions.Fraction(float(lo[i, j])) - exact[i][j])
                    for i in range(d) for j in range(d))
        assert worst <= tol * big, dtype


def test_pulse_train_row_at_the_kernels_chunk():
    """The clustered filter over a pulse-train row of 2^20 samples at
    CHUNK, float64: the first chunk equal to scipy's float64 lfilter (=
    df2t), no farther from the long-double answer than twice scipy's, and
    within 1e-5 of scipy."""
    coef, b, a = _coef('clustered', torch.float64)
    x = iir_cases.pulse_train(1 << 20, 5)[None]
    zi = np.zeros((1, 3))
    y, _ = _run(reference_iir.df2t_blocked, torch.tensor(x), coef,
                torch.tensor(zi))
    y = y.numpy()
    ref = sps.lfilter(b, a, x[0])[None]
    assert (y[:, :reference_iir.CHUNK] == ref[:, :reference_iir.CHUNK]).all()
    ok, _ = _no_farther(y, ref, _longdouble(b, a, x, zi)[0],
                        FLOOR[torch.float64])
    assert ok
    assert float(np.abs(y - ref).max() / np.abs(ref).max()) <= TOL_SCIPY


def test_blocked_model_refuses_a_state_past_the_kernels():
    with pytest.raises(ValueError, match='1 to 16'):
        reference_iir.df2t_blocked(
            torch.zeros(1, 8, dtype=torch.float64),
            torch.zeros(36, dtype=torch.float64),
            torch.zeros(1, 17, dtype=torch.float64),
            torch.empty(1, 8, dtype=torch.float64),
            torch.empty(1, 17, dtype=torch.float64))


@pytest.mark.parametrize('scale', ['normal', 'underflowing', 'subnormal'])
def test_two_prod_is_the_fused_multiply_adds_error(scale):
    """The model's TwoProd error term equals fma(a, b, -a*b), the kernel's
    ``__fma_rn``, bit for bit: the exact a b - p rounded once
    (``fractions.Fraction``), on products of normal size, of a size where
    a partial product of Dekker's split of a and b underflows (a filter's
    state decaying through ~1e-300, as a single exponential's over a long
    quiet row), and of subnormal size."""
    from waveforms_tpu_torch.ops.reference_iir import _two_prod
    rng = np.random.default_rng({'normal': 1, 'underflowing': 2,
                                 'subnormal': 3}[scale])
    lo, hi = {'normal': (-60, 10), 'underflowing': (-1000, -960),
              'subnormal': (-1080, -1030)}[scale]
    a = rng.uniform(-1, 1, 2000) * 2.0 ** rng.integers(-20, 0, 2000)
    b = rng.uniform(-1, 1, 2000) * 2.0 ** rng.integers(lo, hi, 2000)
    p, e = _two_prod(torch.tensor(a), torch.tensor(b))
    assert torch.equal(p, torch.tensor(a * b))
    want = [float(fractions.Fraction(x) * fractions.Fraction(y)
                  - fractions.Fraction(float(q)))
            for x, y, q in zip(a, b, p)]
    assert e.tolist() == want
