"""The plain reference of a table point's plane, from the drawn numbers.

Closed forms of the upstream library's pulses (feihoo87/waveforms), written
out here and evaluated in plain PyTorch on the sample grid ``t_n = n / fs``:

* an XY pulse, ``mixing(amp * cosPulse(w) >> t0, freq=f, phase=phi,
  DRAGScaling=s)[0]``: with the envelope ``e(t) = amp (1 + cos(2 pi (t -
  t0) / w)) / 2`` on ``|t - t0| < w / 2`` and ``om = 2 pi f``, mixing gives
  ``I = e cos(om t - phi)`` and ``Q = -e sin(om t - phi)``, and the DRAG
  correction ``(1 - om s) I - s dQ/dt``, which is ``e cos(om t - phi) + s
  e'(t) sin(om t - phi)``; a stacked line's gate, ``mixing(amp *
  cosPulse(w), ...)[0] >> t0``, is the same with ``t - t0`` in place of
  ``t`` in the carrier;
* a Z pulse, ``amp * (square(w, edge=e) >> t0)``: ``amp (S(u + w/2) -
  S(u - w/2))`` at ``u = t - t0``, with the erf step ``S(v) = 0`` below
  ``-e``, ``(1 + erf(5 v / e)) / 2`` on ``[-e, e)`` and 1 above.

Each pulse is evaluated only on the samples of its own support and added
into a zero plane.  The reference imports nothing of the program and takes
nothing it made: only the configuration and the drawn arrays.
"""

from __future__ import annotations

import math

import torch


def _windows(centres, half, fs, n, device, dtype):
    """Sample indices ``(pulses, W)`` covering each pulse's support
    ``[centre - half, centre + half]`` and their times; indices outside the
    plane are masked out by the caller."""
    W = int(math.ceil(2 * half * fs)) + 3
    n0 = torch.floor((centres - half) * fs).to(torch.int64) - 1
    idx = n0[:, None] + torch.arange(W, device=device)
    return idx, idx.to(dtype) / fs


def _xy(line, p, fs, n, device, dtype):
    s = line.spec
    C, J = line.times.shape[1:]
    t0 = torch.as_tensor(line.times[p], dtype=dtype, device=device).reshape(-1)
    phi = torch.as_tensor(line.phases[p], dtype=dtype, device=device
                          ).reshape(-1)
    om = (2 * math.pi * torch.as_tensor(line.freqs, dtype=dtype,
                                        device=device)).repeat_interleave(J)
    amp = torch.as_tensor(line.amps[p], dtype=dtype, device=device
                          ).reshape(-1, 1)
    w, drag = s['width_s'], s['drag_scaling']
    idx, t = _windows(t0, w / 2, fs, n, device, dtype)
    u = t - t0[:, None]
    arg = (2 * math.pi / w) * u
    inside = u.abs() < w / 2
    env = amp * 0.5 * (1 + torch.cos(arg))
    denv = -amp * 0.5 * (2 * math.pi / w) * torch.sin(arg)
    car = om[:, None] * (u if line.stacked else t) - phi[:, None]
    val = env * torch.cos(car) + drag * denv * torch.sin(car)
    return idx, torch.where(inside, val, torch.zeros_like(val))


def _step(v, e):
    rise = 0.5 + 0.5 * torch.special.erf(v * (5.0 / e))
    return torch.where(v < -e, torch.zeros_like(v),
                       torch.where(v >= e, torch.ones_like(v), rise))


def _z(line, p, fs, n, device, dtype):
    s = line.spec
    t0 = torch.as_tensor(line.times[p], dtype=dtype, device=device).reshape(-1)
    amp = torch.as_tensor(line.amps[p], dtype=dtype, device=device
                          ).reshape(-1, 1)
    w, e = s['width_s'], s['edge_s']
    idx, t = _windows(t0, w / 2 + e, fs, n, device, dtype)
    u = t - t0[:, None]
    return idx, amp * (_step(u + w / 2, e) - _step(u - w / 2, e))


def plane(lines: dict, p: int, n_channels: int, n_samples: int, fs: float,
          device='cpu', dtype=torch.float64) -> torch.Tensor:
    """Point ``p`` of the table as a ``(n_channels, n_samples)`` plane in
    ``dtype``."""
    out = torch.zeros(n_channels * n_samples, dtype=dtype, device=device)
    for line in lines.values():
        idx, val = (_xy if line.kind == 'xy' else _z)(
            line, p, fs, n_samples, device, dtype)
        rows = torch.as_tensor(line.channels, device=device
                               ).repeat_interleave(line.times.shape[2])
        keep = (idx >= 0) & (idx < n_samples)
        flat = rows[:, None] * n_samples + idx
        out.index_add_(0, flat[keep], val[keep])
    return out.view(n_channels, n_samples)


def codes(x: torch.Tensor, scale: float) -> torch.Tensor:
    """DAC codes of a plane: ``x * scale`` rounded half to even and held to
    int16's range, as int32."""
    return torch.round(x * scale).clamp(-32768, 32767).to(torch.int32)
