"""The plain reference of the signal chain: the Z-settle pre-compensation,
the centred FIR and the demodulation, from the configuration's numbers.

The pre-compensation of a line whose step response is ``1 - A exp(-t /
tau)`` is, by the matched-z transform of ``H(s) = 1 - A s / (s + 1/tau)``
inverted, one first-order section a exponential:

    y[n] = p y[n-1] + g (x[n] - z x[n-1]),
    z = exp(-1 / (tau fs)),  p = exp(-1 / ((1 - A) tau fs)),
    g = (1 - p) / (1 - z)      (unit gain at DC),

from a zero state.  Each section's recurrence ``y[n] = p y[n-1] + u[n]``
is computed exactly in blocks: inside a block of ``L`` samples as a product
with the lower-triangular matrix of ``p ** (j - i)``, across blocks by the
same recurrence on the blocks' last values with ``p ** L``.  The FIR is the
centred convolution ``y[n] = sum_k h[k] x[n + K // 2 - k]`` with zeros
outside the plane, the demodulation ``iq[c, j] = sum_n y[c, n] (2 / N)
exp(-i 2 pi f_j n / fs)``.  Plain PyTorch in the dtype asked for; float32
products run at full float32 (TF32 off).  Nothing of the program is
imported.
"""

from __future__ import annotations

import math

import torch

BLOCK = 1024


def sections(amps, taus, fs) -> list[tuple[float, float, float]]:
    """``(g, z, p)`` of each first-order pre-compensation section."""
    out = []
    for A, tau in zip(amps, taus):
        z = math.exp(-1.0 / (tau * fs))
        p = math.exp(-1.0 / ((1.0 - A) * tau * fs))
        out.append(((1.0 - p) / (1.0 - z), z, p))
    return out


def _matmul(a, b):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def ar1(u: torch.Tensor, p: float, block: int = BLOCK) -> torch.Tensor:
    """``y[n] = p y[n-1] + u[n]`` along the last axis of ``(R, N)`` ``u``,
    from ``y[-1] = 0``."""
    R, N = u.shape
    L = min(block, N)
    M = -(-N // L)
    j = torch.arange(L, device=u.device, dtype=u.dtype)
    lag = j[:, None] - j[None, :]
    T = torch.where(lag >= 0, torch.exp(lag.clamp(min=0) * math.log(p)),
                    torch.zeros_like(lag))
    U = torch.nn.functional.pad(u, (0, M * L - N)).view(R, M, L)
    Y = _matmul(U, T.T)
    if M > 1:
        ends = ar1(Y[..., -1], p ** L, block)
        carry = torch.nn.functional.pad(ends[:, :-1], (1, 0))
        Y = Y + carry[..., None] * torch.exp((j + 1) * math.log(p))
    return Y.reshape(R, M * L)[:, :N]


def precompensate(x: torch.Tensor, secs) -> torch.Tensor:
    """The cascade of :func:`sections` on ``(R, N)`` ``x``."""
    for g, z, p in secs:
        u = x.clone()
        u[:, 1:] -= z * x[:, :-1]
        x = ar1(g * u, p)
    return x


def fir_centred(x: torch.Tensor, h) -> torch.Tensor:
    """``y[n] = sum_k h[k] x[n + K // 2 - k]``, zeros outside ``x``."""
    K, N = len(h), x.shape[-1]
    y = torch.zeros_like(x)
    for k, hk in enumerate(h):
        d = K // 2 - k                     # y[n] takes x[n + d]
        if d >= 0:
            y[:, :N - d] += float(hk) * x[:, d:]
        else:
            y[:, -d:] += float(hk) * x[:, :N + d]
    return y


def demod(y: torch.Tensor, tones, fs) -> torch.Tensor:
    """IQ points ``(R, tones)`` of ``(R, N)`` real ``y``, complex."""
    N = y.shape[-1]
    n = torch.arange(N, device=y.device, dtype=torch.float64)
    f = torch.as_tensor(tones, device=y.device, dtype=torch.float64)
    ph = 2 * math.pi * n[:, None] * f[None, :] / fs
    w = 2.0 / N
    re_m = (w * torch.cos(ph)).to(y.dtype)
    im_m = (-w * torch.sin(ph)).to(y.dtype)
    return torch.complex(_matmul(y, re_m), _matmul(y, im_m))
