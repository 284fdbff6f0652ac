"""Tensor lowerings of every basis function, keyed by registry ID.

The port of the JAX package's ``ops/jax_basis.py``.  Each lowering is
called with a float64 (or float32) time tensor and the factor's static
Python arguments, so all parameter-dependent math (Hermite coefficients,
mollifier polynomials, multi-tone DRAG matrices) happens once on the host
and only the t-dependent elementwise work runs on the tensor's device.
The formulas are ``jax_basis.py``'s, operation for operation (``jnp.sinc``
is the normalized sinc, as ``torch.sinc`` is; ``jnp.interp`` and
``jnp.polyval`` are written out as JAX computes them).

Each built-in comes in two halves, :data:`TAPE_BASES`: ``pack(*args)``, the
host's, turns the factor's static arguments into the values that the
tensor half reads (a slice of the trace tape's argument pool,
:mod:`.trace_tape`: floats, complex where an argument is complex), and
``apply(t, p)``, the tensor's, evaluates the basis from them on the
tensor's device, real or complex values alike.  The lowering is ``apply(t,
pack(*args))``; kernel T1 (``csrc/trace_eval.cu``) computes ``apply``'s
formulas from the same pool slice on the card, complex arguments of the
bases in :data:`COMPLEX_ARGS` included.

User functions registered via ``registerBaseFunc``/``function()`` without a
lowering run on the numpy oracle on the host: the grid is copied to the
host and the values back (JAX: ``jax.pure_callback``).  A built-in never
does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ir import registry as _reg
from ..models.multy_drag import edge_blend_poly

__all__ = ['registerTraceable', 'get_traceable', 'traceableBaseFunc',
           'TAPE_BASES', 'COMPLEX_ARGS', 'complex_on_card', 'is_builtin']

#: id -> callable(t, *static_args) -> tensor
traceableBaseFunc: dict = {}


def registerTraceable(fun_id: int, func) -> None:
    """Attach a tensor lowering to a basis-function ID."""
    traceableBaseFunc[fun_id] = func


def get_traceable(fun_id: int):
    """Tensor lowering for *fun_id*, or the host oracle's body."""
    fn = traceableBaseFunc.get(fun_id)
    if fn is not None:
        return fn
    return _host_lowering(fun_id)


def _host_lowering(fun_id: int):
    """The host oracle's body as a lowering: the grid goes to the host and
    the values come back (JAX: ``jax.pure_callback``)."""
    host = _reg.baseFunc[fun_id]

    def fallback(t, *args):
        # the host body's result dtype, probed once: a complex-valued user
        # basis keeps its imaginary part
        np_dtype = np.float64 if t.dtype == torch.float64 else np.float32
        probe = np.asarray(host(np.zeros(1, dtype=np_dtype), *args))
        if np.iscomplexobj(probe):
            out_dtype = (np.complex128 if t.dtype == torch.float64
                         else np.complex64)
        else:
            out_dtype = np_dtype
        vals = np.asarray(host(t.detach().cpu().numpy(), *args),
                          dtype=out_dtype)
        return torch.from_numpy(np.ascontiguousarray(vals)).to(t.device)

    return fallback


def _const(x, t):
    """A host constant as a tensor of ``t``'s dtype (its complex type where
    ``x`` is complex) on its device."""
    x = np.ascontiguousarray(x)
    dtype = t.dtype
    if np.iscomplexobj(x):
        dtype = (torch.complex128 if t.dtype == torch.float64
                 else torch.complex64)
    return torch.as_tensor(x, dtype=dtype, device=t.device)


def _polyval(coeffs, x):
    """``jnp.polyval``: Horner's rule from zero, highest power first."""
    y = torch.zeros_like(x)
    for c in coeffs:
        y = y * x + c
    return y


# ---------------------------------------------------------------------------
# Built-ins (IDs 1..15 + multi-tone DRAG 16/17), each as pack + apply
# ---------------------------------------------------------------------------

#: id -> (pack, apply) of every built-in basis (the pool layouts that
#: csrc/trace_eval.cu reads are the ``pack`` functions' outputs)
TAPE_BASES: dict = {}
_BUILTIN_LOWERINGS: dict = {}


def _num(x):
    """A pool value: complex where the argument is complex, else float."""
    if isinstance(x, (complex, np.complexfloating)):
        return complex(x)
    return float(x)


def _builtin(fun_id, pack, apply):
    def lowering(t, *args):
        return apply(t, pack(*args))

    TAPE_BASES[fun_id] = (pack, apply)
    _BUILTIN_LOWERINGS[fun_id] = lowering
    registerTraceable(fun_id, lowering)


def is_builtin(fun_id) -> bool:
    """Whether *fun_id*'s lowering is the built-in one (not replaced by a
    ``registerTraceable`` of the user's)."""
    fn = _BUILTIN_LOWERINGS.get(fun_id)
    return fn is not None and traceableBaseFunc.get(fun_id) is fn


def _scalar():
    """pack of a basis whose pool is its arguments as they are."""
    def pack(*args):
        return [_num(a) for a in args]
    return pack


def _pack_none():
    return []


def _a_linear(t, p):
    return t


def _a_gaussian(t, p):
    return torch.exp(-((t / p[0]) ** 2))


def _a_erf(t, p):
    return torch.special.erf(t / p[0])


def _a_cos(t, p):
    return torch.cos(p[0] * t)


def _a_sinc(t, p):
    return torch.sinc(p[0] * t)


def _a_exp(t, p):
    return torch.exp(p[0] * t)


def _p_interp(start, stop, points):
    points = list(points)
    if not points:
        raise ValueError("interp takes at least one point")
    xp = np.linspace(start, stop, len(points))
    return [float(len(points)), *map(_num, xp), *map(_num, points)]


def _a_interp(t, p):
    """``jnp.interp(t, xp, fp)`` (``xp = linspace(start, stop, n)``), its
    edge rules included: constant outside [xp[0], xp[-1]], a zero-width
    interval takes its left value; ``fp`` may be complex.  Pool: n,
    xp[n], fp[n]."""
    n = int(np.real(p[0]))
    xp = _const(np.real(p[1:1 + n]), t)
    fp = _const(p[1 + n:1 + 2 * n], t)
    i = torch.clamp(torch.searchsorted(xp, t, right=True), 1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = t - xp[i - 1]
    eps = np.spacing(np.finfo(np.float64 if t.dtype == torch.float64
                              else np.float32).eps)
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(t < xp[0], fp[0], f)
    return torch.where(t > xp[-1], fp[-1], f)


def _p_linear_chirp(f0, f1, T, phi0):
    return [_num(phi0), _num((f1 - f0) / (2 * T)), _num(f0)]


def _a_linear_chirp(t, p):
    return torch.sin(p[0] + 2 * np.pi * (p[1] * t**2 + p[2] * t))


def _p_exponential_chirp(f0, alpha, phi0):
    return [_num(phi0), _num(2 * np.pi * f0), _num(alpha)]


def _a_exponential_chirp(t, p):
    return torch.sin(p[0] + p[1] * (torch.exp(p[2] * t) - 1) / p[2])


def _p_hyperbolic_chirp(f0, k, phi0):
    return [_num(phi0), _num(2 * np.pi * f0 / k), _num(k)]


def _a_hyperbolic_chirp(t, p):
    return torch.sin(p[0] + p[1] * torch.log(1 + p[2] * t))


def _a_cosh(t, p):
    return torch.cosh(p[0] * t)


def _a_sinh(t, p):
    return torch.sinh(p[0] * t)


def _p_drag(t0, freq, width, delta, block_freq, phase):
    o = np.pi / width
    head = [t0, o, 2 * np.pi * (freq + delta),
            2 * np.pi * delta * t0 + phase]
    if block_freq is None or block_freq - delta == 0:
        return [*map(_num, head), 0.0, 0.0, 0.0]
    b = 1 / np.pi / 2 / (block_freq - delta)
    return [*map(_num, head), 1.0, _num(-b * o), _num(2 * o)]


def _a_drag(t, p):
    """Pool: t0, o, 2 pi (freq + delta), 2 pi delta t0 + phase, whether
    there is a Y quadrature, -b o, 2 o."""
    t0, o, w, ph, has_y, by, o2 = p[:7]
    omega_x = torch.sin(o * (t - t0)) ** 2
    wt = w * t - ph
    if not has_y:
        return omega_x * torch.cos(wt)
    omega_y = by * torch.sin(o2 * (t - t0))
    return omega_x * torch.cos(wt) + omega_y * torch.sin(wt)


def _p_mollifier(r, d):
    coeffs = ([] if d == 0 else
              [float(c) for c in _reg.mollifier_poly(d).coeffs])
    return [_num(r), float(d), _num(r**d), float(len(coeffs)), *coeffs]


def _a_mollifier(t, p):
    """Pool: r, d, r ** d, the number of coefficients, the coefficients of
    ``mollifier_poly(d)``."""
    r, d, rd, nc = p[0], int(p[1]), p[2], int(p[3])
    x = t / r
    xx_1 = torch.abs(x) ** 2 - 1
    # guard the pole at |x| == 1 (masked out by the where)
    safe = torch.where(xx_1 >= 0, -1.0, xx_1)
    bump = torch.exp(1 / safe + 1)
    if d == 0:
        return torch.where(xx_1 >= 0, 0.0, bump)
    return torch.where(xx_1 >= 0, 0.0,
                       bump / (-safe) ** (2 * d)) * _polyval(
                           p[4:4 + nc], x) / rd


def _p_d_gaussian(std_sq2, n):
    coeffs = [float(c) for c in _reg.hermite_coefficients(n)]
    return [_num(std_sq2), _num((-1) ** n / std_sq2**n), float(len(coeffs)),
            *coeffs]


def _a_d_gaussian(t, p):
    """Pool: std_sq2, (-1) ** n / std_sq2 ** n, the number of Hermite
    coefficients, the coefficients."""
    u = t / p[0]
    nc = int(p[2])
    return p[1] * _polyval(p[3:3 + nc], u) * torch.exp(-(u**2))


# -- multi-tone DRAG ---------------------------------------------------------
# All matrix algebra is static (host numpy); only masks, sin/cos powers and
# the final linear combination run on the tensor.  cf. models/multy_drag.py.
# Pool of both: a head of MULTI_HEAD values (t0, t0 + width / 2, t0 +
# plateau + width / 2, plateau, o, m, nb = the number of blocking tones,
# the normalization (1 for drag_sinx, which applies none), 2 pi (freq +
# delta), 2 pi delta t0 + phase, and drag_sinx's blend window: its left
# edge, its right edge and width / 2), then A (nb + 1, m + 1) row-major,
# the columns B[:, 0, 0] and B[:, 1, 0]; drag_sinx then, for each row n of
# nb + 1, its left and its right blend polynomial's n-th derivative, each
# as its length and its coefficients (highest power first).

MULTI_HEAD = 13


def _tones(block_freq):
    if block_freq is not None and not hasattr(block_freq, '__len__'):
        return (block_freq,)
    return block_freq


def _multi_head(t0, freq, width, delta, phase, plateau, m, nb, norm,
                blend=(0.0, 0.0, 0.0)):
    return [*map(_num, (t0, t0 + width / 2, t0 + plateau + width / 2,
                        plateau, np.pi / width, m, nb, norm,
                        2 * np.pi * (freq + delta),
                        2 * np.pi * delta * t0 + phase, *blend))]


def _multi_tables(A_mat, B_mat):
    return [*map(_num, A_mat.ravel()), *map(_num, B_mat[:, 0, 0]),
            *map(_num, B_mat[:, 1, 0])]


def _p_drag_sin(t0, freq, width, delta, block_freq, phase, plateau=0):
    block_freq = _tones(block_freq)
    # the model's own setup/normalization (models/multy_drag.py) IS the
    # oracle this lowering must match -- call it, never re-derive it
    from ..models.multy_drag import _blocking_setup, _normalization
    bs, m, o, B_mat, A_mat = _blocking_setup(width, delta, block_freq)
    coeff = _normalization(B_mat, A_mat, m)
    return (_multi_head(t0, freq, width, delta, phase, plateau, m, len(bs),
                        coeff) + _multi_tables(A_mat, B_mat))


def _multi_unpack(p):
    m, nb = int(p[5]), int(p[6])
    k = MULTI_HEAD
    A = np.asarray(p[k:k + (nb + 1) * (m + 1)]).reshape(nb + 1, m + 1)
    k += (nb + 1) * (m + 1)
    B = np.stack([p[k:k + nb + 1], p[k + nb + 1:k + 2 * (nb + 1)]], axis=1)
    return m, nb, A, B, k + 2 * (nb + 1)


def _t_envelope_rows(t, t0, e1, e2, plateau, o, m):
    rise = t <= e1
    flat = (t > e1) & (t < e2)
    base_t = torch.where(rise, t - t0, t - t0 - plateau)
    s = torch.where(flat, 0.0, torch.sin(o * base_t))
    c = torch.where(flat, 0.0, torch.cos(o * base_t))
    ps = torch.arange(m + 1, device=t.device)
    rows = s[None, :] ** ps[:, None]
    rows[1::2] = rows[1::2] * c[None, :]
    return rows, flat


def _a_drag_sin(t, p):
    t0, e1, e2, plateau, o = p[:5]
    coeff, w, ph = p[7:10]
    m, nb, A_mat, B0, _ = _multi_unpack(p)
    rows, flat = _t_envelope_rows(t, t0, e1, e2, plateau, o, m)
    rows = _const(A_mat, t) @ rows
    rows[0] = torch.where(flat, 1.0, rows[0])
    # Omega_j(t) = sum_i B[i, j, 0] * rows_i(t)
    omega = torch.einsum('ij,im->jm', _const(B0, t), rows) / coeff
    wt = w * t - ph
    return omega[0] * torch.cos(wt) + omega[1] * torch.sin(wt)


def _p_drag_sinx(t0, freq, width, delta, block_freq, phase, plateau=0,
                 tab=0.618):
    block_freq = _tones(block_freq)
    from ..models.multy_drag import _blocking_setup
    bs, m, o, B_mat, A_mat = _blocking_setup(width, delta, block_freq)

    def edge_rows(sign):
        x = np.sin(o * (1 + sign * tab) * width / 2) ** np.arange(m + 1)
        x[1::2] = x[1::2] * np.cos(o * (1 + sign * tab) * width / 2)
        return A_mat @ x

    poly_left = edge_blend_poly(edge_rows(-1), -tab * width / 2)
    poly_right = edge_blend_poly(edge_rows(+1), tab * width / 2)
    blend = (t0 + width / 2 - tab * width / 2,
             t0 + plateau + width / 2 + tab * width / 2, width / 2)
    out = (_multi_head(t0, freq, width, delta, phase, plateau, m, len(bs),
                       1.0, blend) + _multi_tables(A_mat, B_mat))
    for n in range(len(bs) + 1):
        for poly in (poly_left, poly_right):
            cs = [_num(c) for c in np.polyder(poly, m=n).coeffs]
            out += [float(len(cs)), *cs]
    return out


def _a_drag_sinx(t, p):
    t0, e1, e2, plateau, o = p[:5]
    w, ph, left_lo, right_hi, half = p[8:13]
    m, nb, A_mat, B0, k = _multi_unpack(p)
    rows, flat = _t_envelope_rows(t, t0, e1, e2, plateau, o, m)
    rows = _const(A_mat, t) @ rows
    rows[0] = torch.where(flat, 1.0, rows[0])
    left = (t >= left_lo) & (t <= e1)
    right = (t >= e2) & (t <= right_hi)
    dt_left = t - t0 - half
    dt_right = t - t0 - plateau - half
    patched = []
    for n in range(nb + 1):
        nl = int(p[k])
        cl = p[k + 1:k + 1 + nl]
        k += 1 + nl
        nr = int(p[k])
        cr = p[k + 1:k + 1 + nr]
        k += 1 + nr
        row = torch.where(left, _polyval(cl, dt_left), rows[n])
        row = torch.where(right, _polyval(cr, dt_right), row)
        patched.append(row)
    rows = torch.stack(patched)
    omega = torch.einsum('ij,im->jm', _const(B0, t), rows)
    wt = w * t - ph
    return omega[0] * torch.cos(wt) + omega[1] * torch.sin(wt)


_builtin(_reg.LINEAR, _pack_none, _a_linear)
_builtin(_reg.GAUSSIAN, _scalar(), _a_gaussian)
_builtin(_reg.ERF, _scalar(), _a_erf)
_builtin(_reg.COS, _scalar(), _a_cos)
_builtin(_reg.SINC, _scalar(), _a_sinc)
_builtin(_reg.EXP, _scalar(), _a_exp)
_builtin(_reg.INTERP, _p_interp, _a_interp)
_builtin(_reg.LINEARCHIRP, _p_linear_chirp, _a_linear_chirp)
_builtin(_reg.EXPONENTIALCHIRP, _p_exponential_chirp, _a_exponential_chirp)
_builtin(_reg.HYPERBOLICCHIRP, _p_hyperbolic_chirp, _a_hyperbolic_chirp)
_builtin(_reg.COSH, _scalar(), _a_cosh)
_builtin(_reg.SINH, _scalar(), _a_sinh)
_builtin(_reg.DRAG, _p_drag, _a_drag)
_builtin(_reg.MOLLIFIER, _p_mollifier, _a_mollifier)
_builtin(_reg.D_GAUSSIAN, _p_d_gaussian, _a_d_gaussian)

#: the built-ins whose complex arguments T1 evaluates on the card (a
#: complex pool slice: its real parts, then its imaginary parts); any other
#: built-in with a complex argument is an external slot of the trace tape,
#: filled by its lowering on the grid's device
COMPLEX_ARGS = frozenset({_reg.GAUSSIAN, _reg.COS, _reg.SINC, _reg.EXP,
                          _reg.COSH, _reg.SINH, _reg.INTERP})


def complex_on_card(fun_id, p) -> bool:
    """Whether T1 evaluates the pool slice ``p`` (``pack``'s output, with a
    complex value) of built-in *fun_id*: a basis of :data:`COMPLEX_ARGS`,
    and for interp only its points complex, not its count or its grid."""
    if fun_id not in COMPLEX_ARGS:
        return False
    if fun_id == _reg.INTERP:
        return all(isinstance(v, float) for v in p[:1 + int(p[0])])
    return True


def _register_multi_drag():
    # IDs 16/17 exist once models.multy_drag has imported (it has: we import
    # from it above, which triggers registration).
    from ..models.multy_drag import DRAG_SIN, DRAG_SINX
    _builtin(DRAG_SIN, _p_drag_sin, _a_drag_sin)
    _builtin(DRAG_SINX, _p_drag_sinx, _a_drag_sinx)


_register_multi_drag()
