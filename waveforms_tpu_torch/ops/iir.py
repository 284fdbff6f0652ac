"""IIR filtering on the card: the recurrence kernel S1, and doubling scans.

The port of the JAX package's ``waveforms_tpu/ops/iir.py``; the names map
one to one, except ``predistort_jax`` -> :func:`predistort_device`.

An IIR filter is a linear recurrence.  The JAX module runs it, where it is
well conditioned, in O(log n) depth as a doubling scan over affine state
maps: each sample contributes ``k * x[n]`` to the direct-form-II-transposed
state, and level ``j`` of the scan adds ``M^(2^j)`` times the state ``2^j``
samples back.  Where the doubling scan is numerically unstable (clustered
near-unit poles, a defective biquad), it runs the direct form as a
``lax.scan``.  That choice suits a TPU, where XLA fuses a level into one
pass and a sequential scan is slow.

The port decides by the signal's device (:func:`_route`):

- On the card every real section of 1 to 16 states runs the hand-written
  recurrence kernel S1 (``csrc/iir_df2t.cu``, through ``kernels.iir_df2t``:
  a blocked parallel-in-time scan with a double-double carry, equal to the
  sequential recurrence over each row's first chunk and closer to the
  exact answer beyond): every ``lfilter``, every ``sosfilt`` section, and
  each real pole of ``filter_zpk`` with the real zero beside it.  Only
  ``filter_zpk``'s complex pole pairs keep the (complex) doubling scan,
  since S1 is real.
- On CPU tensors every filter takes the route it takes in JAX: the JAX
  module's host probe, copied unchanged (:func:`_doubling_unstable` and
  the defective-section test), between the doubling scan in plain torch
  (the JAX module's order of operations: concatenate, ``@``, add) and S1's
  sequential plain version (``ops/reference_iir.py``).

Signals are tensors of any leading batch shape with time on the last axis
(JAX ``vmap``s a 1-D function over rows; here the batch is written out).
``zi`` is one state for every row, or one per row.  A signal given as a
host array goes to ``device`` (default ``'cuda'``, which raises without a
GPU; pass ``'cpu'`` for the plain versions).  Results keep the signal's
dtype on every route (JAX's doubling ``lfilter`` promotes an f32 signal
to f64 through its float64 ``b[0]``; the port does not).

``sosfilt``/``lfilter`` accept and return ``zi``/``zf`` with scipy's
semantics, for chunked streaming.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import annotate
from .reference_iir import MAX_STATE
from .synth import resolve_device

__all__ = ['sosfilt', 'lfilter', 'lfilter_zf', 'state_maps', 'shard_carry',
           'filter_zpk', 'iir_apply', 'predistort_device']


def _as_signal(x, device='cuda') -> torch.Tensor:
    """``x`` itself when it is a tensor, else a tensor of it on
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def _like(values, x) -> torch.Tensor:
    """Host values as a tensor of ``x``'s dtype on ``x``'s device."""
    if isinstance(values, torch.Tensor):
        return values.to(dtype=x.dtype, device=x.device)
    return torch.as_tensor(np.asarray(values)).to(dtype=x.dtype,
                                                  device=x.device)


def _affine_scan_const(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """s[n] = M @ s[n-1] + v[n] (s[-1] = 0) for a CONSTANT recurrence map,
    over axis -2 of ``v`` (..., n, d).

    At doubling level j the operator is the same ``M^(2^j)`` for every
    sample, squared once per level on the d x d matrix, so the state sweep
    is a weighted prefix sum,

        s_j+1[i] = s_j[i] + M^(2^j) @ s_j[i - 2^j],

    O(n d^2 log n) operations through (..., n, d) tensors.  ``v`` is
    scanned in place and returned (the product of each level is formed in
    full before it is added), so callers pass a tensor of their own."""
    n = v.shape[-2]
    s = v
    P = M
    shift = 1
    while shift < n:
        s[..., shift:, :] += s[..., :-shift, :] @ P.T
        P = P @ P
        shift *= 2
    return s


def _doubling_unstable(M_np: np.ndarray, n: int,
                       limit: float = 1e6) -> bool:
    """Host probe: walk the squarings the doubling scan would perform.

    Clustered near-unit poles (multi-exponential precompensation at
    d >= 3) make the companion matrix highly non-normal: ``M^(2^k)`` has
    a huge transient before decaying, and every squaring amplifies
    rounding error by that transient -- at d = 3 with poles ~1e-4 apart,
    f64 squaring of M^2048 is already wrong in its second digit.  Any
    power-magnitude excursion past ``limit`` routes to the direct-form
    recurrence.  (Copied unchanged from the JAX module.)
    """
    P = np.asarray(M_np, np.float64)
    shift = 1
    while shift < n:
        if not np.all(np.isfinite(P)) or np.abs(P).max() > limit:
            return True
        P = P @ P
        shift *= 2
    return False


def _ar1_doubling(lam, u: torch.Tensor) -> torch.Tensor:
    """Prefix scan of the first-order section s[n] = lam*s[n-1] + u[n]
    along the last axis of ``u``.

    Scalar (or complex-scalar) operator powers ``lam^(2^k)`` carry no
    companion-matrix cancellation, so doubling is stable for any
    |lam| <= 1; each level adds true partial sums with coefficients
    bounded by 1.  The powers are squared in ``u``'s dtype, as JAX does.
    ``u`` is scanned in place and returned: callers pass a tensor of their
    own.
    """
    s = u
    p = torch.tensor(lam, dtype=u.dtype, device=u.device)
    shift = 1
    n = u.shape[-1]
    while shift < n:
        s[..., shift:] += p * s[..., :-shift]
        p = p * p
        shift *= 2
    return s


def _delay(y: torch.Tensor, k: int = 1) -> torch.Tensor:
    return torch.cat([y.new_zeros(y.shape[:-1] + (k,)), y[..., :-k]], -1)


def filter_zpk(z, p, k, x, device='cuda') -> torch.Tensor:
    """Numerically stable IIR from the FACTORED (zpk) form.

    H(z) = k * prod (1 - z_i/z) / (1 - p_i/z), applied as a series of
    first-order sections, each pole next to the zero that nearly cancels
    it (real roots sorted in descending order and paired by index, as JAX
    pairs them); zero initial state.  Real poles: on the card, each with
    the real zero at its index as one d = 1 section of the recurrence
    kernel S1; on CPU tensors, as in JAX, the zero as a 1-tap FIR and the
    pole as a real AR1 doubling scan.  An unpaired real zero is a 1-tap FIR
    on both.  Complex pairs: a complex AR1 doubling scan (complex128 for an
    f64 signal, complex64 for f32) followed by its conjugate, zeros as
    2-tap FIR sections, on every device.  The path for clustered-pole
    pre-compensation: keep the factored form end to end
    (``exp_decay_filter(..., output='zpk')``).
    """
    x = _as_signal(x, device)
    z = np.atleast_1d(np.asarray(z, complex))
    p = np.atleast_1d(np.asarray(p, complex))
    if abs(np.imag(k)) > 1e-12 * max(1.0, abs(k)):
        raise ValueError(f"filter_zpk gain must be real, got {k!r}")
    g = float(np.real(k))

    def split(roots):
        real, cplx, neg = [], [], []
        for r in roots:
            if abs(r.imag) <= 1e-12 * max(1.0, abs(r)):
                real.append(float(r.real))
            elif r.imag > 0:
                cplx.append(complex(r))
            else:
                neg.append(complex(np.conj(r)))
        # a real transfer function needs conjugate symmetry; silently
        # dropping an unpaired root would yield a wrong filter
        key = lambda c: (c.real, c.imag)                     # noqa: E731
        pos_s, neg_s = sorted(cplx, key=key), sorted(neg, key=key)
        if len(pos_s) != len(neg_s) or any(
                abs(a - b) > 1e-9 * max(1.0, abs(a))
                for a, b in zip(pos_s, neg_s)):
            raise ValueError(
                "filter_zpk requires conjugate-symmetric roots (real "
                f"transfer function); got {list(roots)}")
        return real, cplx

    zr, zc = split(z)
    pr, pc = split(p)
    zr.sort(reverse=True)
    pr.sort(reverse=True)
    zc.sort(key=lambda c: -c.real)
    pc.sort(key=lambda c: -c.real)

    n = x.shape[-1]
    y = x * g                       # a tensor of our own from here on
    for i in range(max(len(pr), len(zr))):
        if i < len(pr) and _route(y.device, [1.0, -pr[i]], n,
                                  'zpk') == 'S1':
            # pole i and zero i as one section, b = [1, -zr[i]] (an
            # unpaired pole: [1, 0]), a = [1, -pr[i]].  Its direct form,
            # y[n] = x[n] + s and s' = -zr[i] x[n] + pr[i] y[n], is
            # y[n] = (x[n] - zr[i] x[n-1]) + pr[i] y[n-1]: the FIR below
            # followed by the AR1 scan, in one recurrence
            b1 = -zr[i] if i < len(zr) else 0.0
            y = _sequential_filter(np.array([1.0, b1]),
                                   np.array([1.0, -pr[i]]), y,
                                   y.new_zeros((1,)))[0]
            continue
        if i < len(zr):
            y = y - zr[i] * _delay(y)
        if i < len(pr):
            y = _ar1_doubling(pr[i], y)
    cdt = torch.complex128 if x.dtype == torch.float64 else torch.complex64
    for i in range(max(len(pc), len(zc))):
        if i < len(zc):
            zeta = zc[i]
            y = (y - 2 * zeta.real * _delay(y)
                 + abs(zeta) ** 2 * _delay(y, 2))
        if i < len(pc):
            lam = pc[i]
            yc = _ar1_doubling(lam, y.to(cdt))
            yc = _ar1_doubling(np.conj(lam), yc)
            y = yc.real.to(x.dtype)
    return y


def _sequential_filter(bb: np.ndarray, aa: np.ndarray, x: torch.Tensor,
                       zi0: torch.Tensor, state_only: bool = False,
                       coef: torch.Tensor | None = None):
    """Direct form II transposed, exact scipy semantics including zi/zf:
    the recurrence kernel S1 over the rows of ``x`` (JAX: a ``lax.scan``;
    on the card a blocked scan, on CPU tensors the sequential plain
    version), with the coefficients ``bb``, ``aa`` (float64) in ``x``'s
    dtype.  The route of every real section on the card; on CPU tensors,
    as in JAX, where the doubling scan is numerically unstable.
    ``state_only``: S1's state-only call, (None, zf).  ``coef``: b then
    a, already in ``x``'s dtype on its device (by default made here)."""
    from .. import kernels
    d = len(bb) - 1
    lead, n = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, n).contiguous()
    zi = zi0.expand(lead + (d,)).reshape(-1, d).contiguous()
    if coef is None:
        coef = _like(np.concatenate([bb, aa]), x)
    y = None if state_only else torch.empty_like(rows)
    zf = torch.empty_like(zi)
    kernels.iir_df2t(rows, coef, zi, y, zf)
    return (None if state_only else y.reshape(x.shape),
            zf.reshape(lead + (d,)))


def _doubling_df2t(M: torch.Tensor, k: torch.Tensor, b0, x: torch.Tensor,
                   zi: torch.Tensor):
    """Direct form II transposed by the doubling scan:
    s[n] = M s[n-1] + k x[n], y[n] = b0 x[n] + s0[n-1], from state ``zi``
    injected through the first element -> (y, zf)."""
    zi = zi.expand(x.shape[:-1] + zi.shape[-1:])
    vs = x[..., None] * k
    vs[..., 0, :] += zi @ M.T
    s = _affine_scan_const(M, vs)
    s0_prev = torch.cat([zi[..., :1], s[..., :-1, 0]], -1)
    y = b0 * x + s0_prev
    return y, s[..., -1, :]


def _biquad(x, b, a, zi):
    """One second-order section (direct form II transposed), parallel in n.

    State s = (z0, z1):
        y[n]  = b0 x[n] + z0[n-1]
        z0[n] = b1 x[n] - a1 y[n] + z1[n-1]
        z1[n] = b2 x[n] - a2 y[n]
    which is affine in s with a *constant* M.  ``b``, ``a`` are host
    tensors of ``x``'s dtype; M and k are formed in it, as JAX forms them.
    """
    b0, b1, b2 = b[0], b[1], b[2]
    a1, a2 = a[1], a[2]
    M = torch.stack([torch.stack([-a1, torch.ones_like(a1)]),
                     torch.stack([-a2, torch.zeros_like(a2)])])
    k = torch.stack([b1 - a1 * b0, b2 - a2 * b0])
    return _doubling_df2t(_like(M, x), _like(k, x), b0.to(x.device), x, zi)


def _defective(a_np) -> bool:
    """A DEFECTIVE near-unit section (repeated root at |r| ~ 1, e.g. the
    matched-z transform of a double pole) grows only linearly -- under the
    norm limit -- yet its non-diagonalizable powers still amplify scan
    rounding to ~1e-3 over 1e5 samples; caught by the discriminant.
    (The JAX module's test, unchanged.)"""
    disc = a_np[1] ** 2 - 4.0 * a_np[2]
    return bool(abs(disc) <= 1e-9 * max(1.0, a_np[1] ** 2)
                and np.abs(np.roots([1.0, a_np[1], a_np[2]])).max()
                > 1.0 - 1e-4)


def _route(device, aa, n, form='lfilter') -> str:
    """The route of one real section with normalised denominator ``aa``
    over rows of ``n`` samples (the length that decides: a time shard
    passes its whole row's) of a signal on ``device``: ``'S1'``, the
    recurrence kernel, or ``'doubling'``, the doubling scan.

    On the card, S1 for every section of 1 to MAX_STATE states, whatever
    ``n``: at every shape the main paths give a filter, from one shot's
    2 x 200,000 samples to the flagship's 128 x 2,000,000, it is 6x to
    135x faster than the doubling scan on an NVIDIA H100 80GB HBM3 at
    700 W (``chip_smoke.py``'s ``iir_routes`` record, PERF.md section 5),
    and at least as accurate, so there is no crossover.  On CPU tensors,
    and above MAX_STATE states on the card, the JAX module's host rule for
    the calling ``form``: ``'lfilter'`` takes S1 where the doubling scan's
    squarings are unstable; ``'sos'`` (one biquad of sosfilt) also for a
    defective section; ``'zpk'`` (a real pole of filter_zpk) always takes
    the doubling scan."""
    d = len(aa) - 1
    if torch.device(device).type == 'cuda' and 1 <= d <= MAX_STATE:
        return 'S1'
    if form == 'zpk':
        return 'doubling'
    if form == 'sos' and _defective(aa):
        return 'S1'
    M = _state_space(aa, aa, d)[0]          # M is a's alone
    return 'S1' if _doubling_unstable(M, n) else 'doubling'


def sosfilt(sos, x, zi=None, device='cuda'):
    """Cascaded second-order sections, scipy-compatible, over the last axis
    of ``x``.

    sos: (n_sections, 6).  With ``zi`` of shape (n_sections, 2) or
    (..., n_sections, 2), returns ``(y, zf)`` with zf (..., n_sections, 2);
    without, returns ``y`` (zero initial state).  Each section runs the
    recurrence kernel S1 on the card, with its own ``zi`` and ``zf``, in
    the cascade's order; on CPU tensors it takes the doubling scan, or S1
    where that would be unstable, as the JAX module routes it.
    """
    x = _as_signal(x, device)
    sos_np = np.asarray(sos.cpu() if isinstance(sos, torch.Tensor) else sos,
                        dtype=float)
    sos_x = torch.as_tensor(sos_np).to(x.dtype)      # JAX: sos in x.dtype
    return_zf = zi is not None
    zi = (x.new_zeros((sos_np.shape[0], 2)) if zi is None
          else _like(zi, x))
    n = x.shape[-1]
    zf = []
    for k in range(sos_np.shape[0]):
        a_np = sos_np[k, 3:] / sos_np[k, 3]
        if _route(x.device, a_np, n, 'sos') == 'S1':
            b_np = sos_np[k, :3] / sos_np[k, 3]
            x, z = _sequential_filter(b_np, a_np, x, zi[..., k, :])
        else:
            x, z = _biquad(x, sos_x[k, :3] / sos_x[k, 3],
                           sos_x[k, 3:] / sos_x[k, 3], zi[..., k, :])
        zf.append(z)
    if return_zf:
        return x, torch.stack(zf, -2)
    return x


def _normalised(b, a):
    """(b, a) over a[0], both d + 1 long -> (bb, aa, d)."""
    b = np.atleast_1d(np.asarray(b, dtype=float))
    a = np.atleast_1d(np.asarray(a, dtype=float))
    d = max(len(a), len(b)) - 1
    bb = np.zeros(d + 1)
    aa = np.zeros(d + 1)
    bb[:len(b)] = b / a[0]
    aa[:len(a)] = a / a[0]
    return bb, aa, d


def _state_space(bb, aa, d):
    """s[n] = M s[n-1] + k x[n];  y[n] = b0 x[n] + s0[n-1]  -> (M, k)."""
    M = np.zeros((d, d))
    M[:, 0] = -aa[1:]
    M[:-1, 1:] = np.eye(d - 1)
    return M, bb[1:] - aa[1:] * bb[0]


def _lfilter_apply(b, a, zi, n, like):
    """``x -> (y, zf)`` of :func:`lfilter` with ``zi`` (None: a zero
    state) over signals of ``like``'s dtype on its device whose rows have
    ``n`` samples (the length that decides the route, :func:`_route`),
    with the coefficients and the state put there once: a call copies
    nothing from the host and reads nothing back, so a CUDA graph can
    capture it (:func:`..parallel.run_sequence`)."""
    bb, aa, d = _normalised(b, a)
    zi0 = like.new_zeros((d,)) if zi is None else _like(zi, like)
    if d == 0:
        return lambda x: (bb[0] * x, zi0)
    if _route(like.device, aa, n) == 'S1':
        # the card's route; on CPU tensors, clustered near-unit poles,
        # where doubling diverges numerically and no factored realization
        # reproduces (b, a) semantics either, so the exact direct form
        # runs sequentially (callers who hold the factored form should use
        # filter_zpk)
        coef = _like(np.concatenate([bb, aa]), like)
        return lambda x: _sequential_filter(bb, aa, x, zi0, False, coef)
    M, k = _state_space(bb, aa, d)
    M, k, b0 = _like(M, like), _like(k, like), float(bb[0])
    return lambda x: _doubling_df2t(M, k, b0, x, zi0)


def lfilter(b, a, x, zi=None, device='cuda', route_n=None):
    """General (b, a) IIR over the last axis of ``x``: direct form II
    transposed with state dimension ``max(len(a), len(b)) - 1``, by the
    recurrence kernel S1 on the card; on CPU tensors by the doubling scan
    or, where that is unstable, S1, as in JAX (:func:`_route`);
    scipy-compatible ``zi`` (d,) or (..., d) and ``zf``.  ``route_n`` is
    the length that decides the route (default: ``x``'s): a time shard of
    a longer row passes the row's, and takes the row's route.
    """
    x = _as_signal(x, device)
    y, zf = _lfilter_apply(b, a, zi, route_n or x.shape[-1], x)(x)
    return (y, zf) if zi is not None else y


def lfilter_zf(b, a, x, route_n=None, zi=None) -> torch.Tensor:
    """The final state (..., d) of ``lfilter(b, a, x, zi=zi, route_n=...)``
    alone (``zi`` None: a zero state), by the route that call takes
    (:func:`_route`): on S1's, the recurrence kernel's state-only call (S1
    writes no output); else the doubling scan's own final state.  The
    end state of a run of time shards from a zero state, which
    :func:`shard_carry` carries across the runs."""
    bb, aa, d = _normalised(b, a)
    if d == 0:
        return x.new_zeros(x.shape[:-1] + (0,))
    zi0 = x.new_zeros((d,)) if zi is None else _like(zi, x)
    if _route(x.device, aa, route_n or x.shape[-1]) == 'S1':
        return _sequential_filter(bb, aa, x, zi0, state_only=True)[1]
    M, k = _state_space(bb, aa, d)
    return _doubling_df2t(_like(M, x), _like(k, x), float(bb[0]), x,
                          zi0)[1]


def state_maps(b, a, lengths) -> dict:
    """{n: Phi(n)} of the (b, a) filter's state over n zero-input samples,
    for each n of ``lengths``, in double-double on the host
    (:func:`.reference_iir.state_maps`): what :func:`shard_carry` takes as
    ``maps``."""
    from . import reference_iir
    bb, aa, _ = _normalised(b, a)
    return reference_iir.state_maps(
        torch.from_numpy(np.concatenate([bb, aa])), lengths)


def shard_carry(b, a, zf0, lengths, zi, maps=None) -> torch.Tensor:
    """Each time shard's start state (R, P, d) from every shard's end state
    from zero ``zf0`` (R, P, d) and its length: the carry of a filter over a
    row split into P time shards, in parallel over the shards where the
    sequential carry waits on each shard in turn
    (:func:`.reference_iir.shard_carry`, whose steps run here on ``zf0``'s
    device).  The state maps Phi(n) of (b, a) are built on the host in
    double-double (:func:`.reference_iir.state_maps`), or taken from
    ``maps``; the (R, d) steps, P - 1 of them, run in double-double torch on
    the card, with no kernel of their own: they are a few numbers a
    row."""
    from . import reference_iir
    bb, aa, _ = _normalised(b, a)
    coef = torch.from_numpy(np.concatenate([bb, aa]))
    if maps is None:
        maps = state_maps(b, a, list(lengths)[:-1])
    return reference_iir.shard_carry(coef, zf0, lengths, zi, maps)


def iir_apply(sos, x, initial: float = 0.0, device='cuda'):
    """The Waveform.sample() filter contract: subtract/restore a DC
    level."""
    x = _as_signal(x, device)
    if initial:
        return sosfilt(sos, x - initial) + initial
    return sosfilt(sos, x)


def predistort_device(sig, filters=None, ker=None, initial: float = 0.0,
                      device='cuda'):
    """Predistortion on the card: cascaded (b, a) filters + FFT kernel
    (JAX: ``predistort_jax``).

    Mirrors :func:`waveforms_tpu_torch.distortion.predistort` (steady-state
    ``initial`` handling included) with :func:`lfilter` (the recurrence
    kernel S1 on the card) and ``torch.fft`` instead of scipy.  Spans:
    ``wf.chain.coeffs`` (the combined filter and its steady state, on the
    host), ``wf.chain.iir`` (the filter), ``wf.chain.fir`` (the FFT
    convolution).
    """
    sig = _as_signal(sig, device)
    if filters is not None:
        from ..distortion import _steady_state_zi, combine_filters
        with annotate('wf.chain.coeffs'):
            b, a = combine_filters(filters)
            zi = _steady_state_zi(b, a, initial, None, None)
        with annotate('wf.chain.iir'):
            sig, _ = lfilter(b, a, sig, zi=zi)
    if ker is None:
        return sig
    from .fft import fft_convolve_centered
    with annotate('wf.chain.fir'):
        return fft_convolve_centered(sig, _like(ker, sig))
