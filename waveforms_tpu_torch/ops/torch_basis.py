"""Tensor lowerings of every basis function, keyed by registry ID.

The port of the JAX package's ``ops/jax_basis.py``.  Each lowering is
called with a float64 (or float32) time tensor and the factor's static
Python arguments, so all parameter-dependent math (Hermite coefficients,
mollifier polynomials, multi-tone DRAG matrices) happens once on the host
and only the t-dependent elementwise work runs on the tensor's device.
The formulas are ``jax_basis.py``'s, operation for operation (``jnp.sinc``
is the normalized sinc, as ``torch.sinc`` is; ``jnp.interp`` and
``jnp.polyval`` are written out as JAX computes them).

User functions registered via ``registerBaseFunc``/``function()`` without a
lowering run on the numpy oracle on the host: the grid is copied to the
host and the values back (JAX: ``jax.pure_callback``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ir import registry as _reg
from ..models.multy_drag import edge_blend_poly

__all__ = ['registerTraceable', 'get_traceable', 'traceableBaseFunc']

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
    """A host constant as a tensor of ``t``'s dtype on its device."""
    return torch.as_tensor(np.asarray(x), dtype=t.dtype, device=t.device)


def _polyval(coeffs, x):
    """``jnp.polyval``: Horner's rule from zero, highest power first."""
    y = torch.zeros_like(x)
    for c in coeffs:
        y = y * x + c
    return y


# ---------------------------------------------------------------------------
# Built-ins (IDs 1..15 + multi-tone DRAG 16/17)
# ---------------------------------------------------------------------------


def _t_linear(t):
    return t


def _t_gaussian(t, std_sq2):
    return torch.exp(-((t / std_sq2) ** 2))


def _t_erf(t, std_sq2):
    return torch.special.erf(t / std_sq2)


def _t_cos(t, w):
    return torch.cos(w * t)


def _t_sinc(t, bw):
    return torch.sinc(bw * t)


def _t_exp(t, alpha):
    return torch.exp(alpha * t)


def _t_interp(t, start, stop, points):
    """``jnp.interp(t, linspace(start, stop, n), points)``, its edge rules
    included: constant outside [xp[0], xp[-1]], a zero-width interval takes
    its left value."""
    xp = _const(np.linspace(start, stop, len(points)), t)
    fp = _const(points, t)
    i = torch.clamp(torch.searchsorted(xp, t, right=True), 1, len(xp) - 1)
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


def _t_linear_chirp(t, f0, f1, T, phi0):
    return torch.sin(phi0 + 2 * np.pi * ((f1 - f0) / (2 * T) * t**2
                                         + f0 * t))


def _t_exponential_chirp(t, f0, alpha, phi0):
    return torch.sin(phi0 + 2 * np.pi * f0 * (torch.exp(alpha * t) - 1)
                     / alpha)


def _t_hyperbolic_chirp(t, f0, k, phi0):
    return torch.sin(phi0 + 2 * np.pi * f0 / k * torch.log(1 + k * t))


def _t_cosh(t, w):
    return torch.cosh(w * t)


def _t_sinh(t, w):
    return torch.sinh(w * t)


def _t_drag(t, t0, freq, width, delta, block_freq, phase):
    o = np.pi / width
    omega_x = torch.sin(o * (t - t0)) ** 2
    wt = 2 * np.pi * (freq + delta) * t - (2 * np.pi * delta * t0 + phase)
    if block_freq is None or block_freq - delta == 0:
        return omega_x * torch.cos(wt)
    b = 1 / np.pi / 2 / (block_freq - delta)
    omega_y = -b * o * torch.sin(2 * o * (t - t0))
    return omega_x * torch.cos(wt) + omega_y * torch.sin(wt)


def _t_mollifier(t, r, d):
    x = t / r
    xx_1 = torch.abs(x) ** 2 - 1
    # guard the pole at |x| == 1 (masked out by the where)
    safe = torch.where(xx_1 >= 0, -1.0, xx_1)
    bump = torch.exp(1 / safe + 1)
    if d == 0:
        return torch.where(xx_1 >= 0, 0.0, bump)
    coeffs = [float(c) for c in _reg.mollifier_poly(d).coeffs]
    return torch.where(xx_1 >= 0, 0.0,
                       bump / (-safe) ** (2 * d)) * _polyval(coeffs,
                                                             x) / r**d


def _t_d_gaussian(t, std_sq2, n):
    u = t / std_sq2
    coeffs = [float(c) for c in _reg.hermite_coefficients(n)]
    return ((-1) ** n / std_sq2**n * _polyval(coeffs, u)
            * torch.exp(-(u**2)))


# -- multi-tone DRAG ---------------------------------------------------------
# All matrix algebra is static (host numpy); only masks, sin/cos powers and
# the final linear combination run on the tensor.  cf. models/multy_drag.py.


def _t_envelope_rows(t, t0, width, plateau, o, m):
    rise = t <= t0 + width / 2
    flat = (t > t0 + width / 2) & (t < t0 + plateau + width / 2)
    base_t = torch.where(rise, t - t0, t - t0 - plateau)
    s = torch.where(flat, 0.0, torch.sin(o * base_t))
    c = torch.where(flat, 0.0, torch.cos(o * base_t))
    ps = torch.arange(m + 1, device=t.device)
    rows = s[None, :] ** ps[:, None]
    rows[1::2] = rows[1::2] * c[None, :]
    return rows, flat


def _t_drag_sin(t, t0, freq, width, delta, block_freq, phase, plateau=0):
    if isinstance(block_freq, float):
        block_freq = (block_freq,)
    # the model's own setup/normalization (models/multy_drag.py) IS the
    # oracle this lowering must match -- call it, never re-derive it
    from ..models.multy_drag import _blocking_setup, _normalization
    bs, m, o, B_mat, A_mat = _blocking_setup(width, delta, block_freq)
    rows, flat = _t_envelope_rows(t, t0, width, plateau, o, m)
    rows = _const(A_mat, t) @ rows

    coeff = _normalization(B_mat, A_mat, m)

    rows[0] = torch.where(flat, 1.0, rows[0])
    # Omega_j(t) = sum_i B[i, j, 0] * rows_i(t)
    omega = torch.einsum('ij,im->jm', _const(B_mat[:, :, 0], t),
                         rows) / coeff
    wt = 2 * np.pi * (freq + delta) * t - (2 * np.pi * delta * t0 + phase)
    return omega[0] * torch.cos(wt) + omega[1] * torch.sin(wt)


def _t_drag_sinx(t, t0, freq, width, delta, block_freq, phase, plateau=0,
                 tab=0.618):
    if isinstance(block_freq, float):
        block_freq = (block_freq,)
    from ..models.multy_drag import _blocking_setup
    bs, m, o, B_mat, A_mat = _blocking_setup(width, delta, block_freq)
    rows, flat = _t_envelope_rows(t, t0, width, plateau, o, m)
    rows = _const(A_mat, t) @ rows

    def edge_rows(sign):
        x = np.sin(o * (1 + sign * tab) * width / 2) ** np.arange(m + 1)
        x[1::2] = x[1::2] * np.cos(o * (1 + sign * tab) * width / 2)
        return A_mat @ x

    poly_left = edge_blend_poly(edge_rows(-1), -tab * width / 2)
    poly_right = edge_blend_poly(edge_rows(+1), tab * width / 2)

    rows[0] = torch.where(flat, 1.0, rows[0])
    left = (t >= t0 + width / 2 - tab * width / 2) & (t <= t0 + width / 2)
    right = ((t >= t0 + plateau + width / 2)
             & (t <= t0 + plateau + width / 2 + tab * width / 2))
    dt_left = t - t0 - width / 2
    dt_right = t - t0 - plateau - width / 2
    patched = []
    for n in range(len(bs) + 1):
        row = rows[n]
        cl = [float(c) for c in np.polyder(poly_left, m=n).coeffs]
        cr = [float(c) for c in np.polyder(poly_right, m=n).coeffs]
        row = torch.where(left, _polyval(cl, dt_left), row)
        row = torch.where(right, _polyval(cr, dt_right), row)
        patched.append(row)
    rows = torch.stack(patched)

    omega = torch.einsum('ij,im->jm', _const(B_mat[:, :, 0], t), rows)
    wt = 2 * np.pi * (freq + delta) * t - (2 * np.pi * delta * t0 + phase)
    return omega[0] * torch.cos(wt) + omega[1] * torch.sin(wt)


registerTraceable(_reg.LINEAR, _t_linear)
registerTraceable(_reg.GAUSSIAN, _t_gaussian)
registerTraceable(_reg.ERF, _t_erf)
registerTraceable(_reg.COS, _t_cos)
registerTraceable(_reg.SINC, _t_sinc)
registerTraceable(_reg.EXP, _t_exp)
registerTraceable(_reg.INTERP, _t_interp)
registerTraceable(_reg.LINEARCHIRP, _t_linear_chirp)
registerTraceable(_reg.EXPONENTIALCHIRP, _t_exponential_chirp)
registerTraceable(_reg.HYPERBOLICCHIRP, _t_hyperbolic_chirp)
registerTraceable(_reg.COSH, _t_cosh)
registerTraceable(_reg.SINH, _t_sinh)
registerTraceable(_reg.DRAG, _t_drag)
registerTraceable(_reg.MOLLIFIER, _t_mollifier)
registerTraceable(_reg.D_GAUSSIAN, _t_d_gaussian)


def _register_multi_drag():
    # IDs 16/17 exist once models.multy_drag has imported (it has: we import
    # from it above, which triggers registration).
    from ..models.multy_drag import DRAG_SIN, DRAG_SINX
    registerTraceable(DRAG_SIN, _t_drag_sin)
    registerTraceable(DRAG_SINX, _t_drag_sinx)


_register_multi_drag()
