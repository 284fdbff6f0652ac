"""The synthesis entry point with route selection.

Engines:

* ``'auto'`` / ``'cuda'`` -- lower on the host, upload the descriptors to
  ``device`` and run the dense or the panel kernel, by occupancy
  (:func:`classify_route`).  On ``device='cuda'`` these are the hand-written
  CUDA kernels; on ``device='cpu'`` their plain PyTorch versions.
* ``'cuda-dense'`` / ``'cuda-panel'`` -- force one of the two kernels.
* ``'numpy'`` -- the host float64 oracle (``Waveform.__call__``), kept for
  tests.

Not ported yet (they raise ``ValueError``): pair mode (``part='complex'``),
bf16/f16 stores and ``precision='double'``.
"""

from __future__ import annotations

import numpy as np

from .ops.lowering import UnsupportedFactor, lower_schedule
from .ops.sparse_synth import (PANEL_OCCUPANCY_THRESHOLD, build_panel_plan,
                               build_sparse_plan, panels_eligible,
                               synthesize_panels)
from .ops.synth import (DeviceSchedule, default_rows_per_tile,
                        normalize_out_dtype, resolve_device,
                        synthesize_device)

__all__ = ['synthesize', 'classify_route', 'ENGINES']

ENGINES = ('auto', 'cuda', 'cuda-dense', 'cuda-panel', 'numpy')


def classify_route(low, force=None, out_dtype=None):
    """Pick the kernel for a lowered schedule -> ``(kind, plan)``, kind in
    {'panel', 'dense'} (``plan`` is the PanelPlan for 'panel').

    The JAX package's occupancy rule (``waveforms_tpu.engine.
    classify_pallas_route``), including its ``small`` rule, decides between
    the two: the panel kernel below PANEL_OCCUPANCY_THRESHOLD of padded
    live subtiles, or when the schedule spans at most two dense tiles per
    channel; the dense kernel otherwise.  The threshold is the JAX
    package's TPU value, unmeasured on the H100.  Schedules that the JAX
    package sends to its stack or worklist ('sparse') kernels, which are
    not ported yet, go to the panel or the dense kernel here; a plan that
    the panel kernel cannot take (int16 with several buckets) goes dense.
    """
    if force not in (None, 'dense', 'panel'):
        raise ValueError(f"unknown route {force!r}")
    if force == 'dense':
        return 'dense', None
    try:
        sparse_plan = build_sparse_plan(low)
    except UnsupportedFactor:
        if force == 'panel':
            raise
        return 'dense', None
    # occupancy against the PADDED tile count of the JAX dense grid, as the
    # JAX router computes it
    NB = low.shape[1]
    R = default_rows_per_tile(low.n_samples, low.bucket_samples, NB)
    n_rows = -(-low.n_samples // 128)
    padded_rows = -(-n_rows // R) * R
    occ = sparse_plan.occupied_fraction * n_rows / padded_rows
    small = padded_rows <= 2 * R
    if force == 'panel' or small or occ < PANEL_OCCUPANCY_THRESHOLD:
        plan = build_panel_plan(low, base=sparse_plan)
        if panels_eligible(plan, normalize_out_dtype(out_dtype)):
            return 'panel', plan
        if force == 'panel':
            raise UnsupportedFactor(
                "int16 panel output needs a single-bucket schedule")
    return 'dense', None


def _quantize_host(out, out_dtype, dac_scale):
    """Host-engine form of the kernels' int16 store: scale ->
    round-half-even -> clip (same convention as the kernels)."""
    if normalize_out_dtype(out_dtype).is_floating_point:
        return out
    sc = np.asarray(dac_scale, np.float64)
    scaled = out * (sc.reshape(-1, 1) if sc.ndim else float(sc))
    return np.clip(np.round(scaled), -32768.0, 32767.0).astype(np.int16)


def _synthesize_numpy(channels, start, stop, sample_rate, part):
    from .core import WaveVStack
    t = np.arange(start, stop, 1 / sample_rate)
    # WaveVStack.__call__ returns the REAL part; 'imag' goes through the
    # stack's complex accumulation, as the descriptor engines lower it
    vals = [np.asarray((ch.simplify() if part != 'real'
                        and isinstance(ch, WaveVStack) else ch)(t))
            for ch in channels]
    vals = [np.real(v) if part == 'real' else np.imag(v) for v in vals]
    return np.stack(vals)


def synthesize(channels, start: float, stop: float, sample_rate: float,
               engine: str = 'auto', bucket_samples='auto',
               part: str = 'real', out_dtype=None, dac_scale=32767.0,
               device='cuda'):
    """Synthesize a list of channels -> (C, N).

    Returns a torch tensor on ``device`` for the kernel engines, f32 or, with
    ``out_dtype=torch.int16`` (or ``np.int16``), DAC codes
    ``clip(round_half_even(x * dac_scale))`` with ``dac_scale`` a scalar or
    per-channel vector.  ``engine='numpy'`` returns the float64 oracle as an
    ndarray (quantized the same way for int16).  ``device='cuda'`` without a
    GPU raises; nothing falls back to the CPU.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if part not in ('real', 'imag'):
        raise ValueError(f"part={part!r}: pair mode (part='complex') is not "
                         "ported yet")
    dt = normalize_out_dtype(out_dtype)
    if engine == 'numpy':
        out = _synthesize_numpy(channels, start, stop, sample_rate, part)
        return _quantize_host(out, dt, dac_scale)
    device = resolve_device(device)
    low = lower_schedule(channels, start, stop, sample_rate, part=part,
                         bucket_samples=bucket_samples)
    force = {'cuda-dense': 'dense', 'cuda-panel': 'panel'}.get(engine)
    kind, plan = classify_route(low, force=force, out_dtype=dt)
    dev = DeviceSchedule(low, device)
    if kind == 'panel':
        return synthesize_panels(dev, plan=plan, out_dtype=dt,
                                 dac_scale=dac_scale)
    return synthesize_device(dev, out_dtype=dt, dac_scale=dac_scale)
