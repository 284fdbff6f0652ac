"""The synthesis entry point with route selection.

Engines:

* ``'auto'`` / ``'cuda'`` -- lower on the host, upload to ``device`` and run
  the kernel that :func:`classify_route` picks by ``device``'s rule
  (:mod:`.ops.routes`): the panel, worklist ('sparse'), stack or dense
  kernel.  On ``device='cuda'`` these are the hand-written CUDA kernels,
  routed by the H100's occupancy ladder; on ``device='cpu'`` their plain
  PyTorch versions, routed as the JAX package routes.
* ``'cuda-dense'`` / ``'cuda-panel'`` / ``'cuda-sparse'`` / ``'cuda-stack'``
  -- force one kernel, as the JAX package's ``'pallas-dense'`` /
  ``'pallas-panel'`` / ``'pallas-sparse'`` / ``'pallas-stack'`` do.
* ``'native'`` -- the C++ host float64 engine (:mod:`.native`, the JAX
  package's ``'native'``): lowers once and runs the descriptor program on
  the CPU cores; returns an ndarray.
* ``'torch'`` -- the trace evaluator (:mod:`.ops.torch_eval`, the JAX
  package's ``'xla'``): every channel's IR in float64 (complex128 where it
  is complex) in one launch of kernel T1 on ``device`` (on a CPU device
  T1's plain version); returns a tensor there.
* ``'numpy'`` -- the host float64 oracle (``Waveform.__call__``), kept for
  tests.

The JAX package's ``'auto'`` falls back to ``'xla'`` and ``'native'`` off
the TPU; the port's ``'auto'`` is the kernel route.

``precision='double'`` runs the double tier (:mod:`.ops.hi_synth`, the
float64 kernels K3 and K4): ``'auto'`` and ``'cuda'`` run
``synthesize_hi_routed``, which routes by the device's rule
(``classify_hi_route``: as the JAX one on the CPU, K3 on the card),
``'cuda-dense'`` forces the dense kernel, and the other forced engines
refuse it, as the JAX package's forced pallas engines do; ``'native'``,
``'torch'`` and ``'numpy'`` compute in float64 already.

``out_dtype`` takes f32, int16 DAC codes, and the narrowed float stores
bf16 and f16 (the f32 sum rounded once at the store), on every route where
the JAX package takes them: not with ``precision='double'`` or
``part='complex'``, and not on a multi-bucket panel, which routes
elsewhere as in JAX.

:func:`sample` is the engine-selected analog of ``Waveform.sample()``: it
synthesizes one waveform and applies the SOS filters attached to it, on
the card (:func:`.ops.iir.iir_apply`, each section on the recurrence
kernel S1) for the kernel engines and ``'torch'``, and with scipy on the
host for ``'numpy'`` and ``'native'``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.hi_synth import (check_hi_schedule, synthesize_hi,
                           synthesize_hi_routed)
from .ops.lowering import UnsupportedFactor, lower_schedule
from .ops.routes import (facts, rule_for, stack_first, stack_wins,
                         store_kind, takes_worklist)
from .ops.sparse_synth import (build_panel_plan, build_sparse_plan,
                               panels_eligible, synthesize_panels,
                               synthesize_sparse)
from .ops.stack_synth import build_stack_plan, synthesize_stack
from .ops.synth import (DeviceSchedule, normalize_out_dtype, resolve_device,
                        synthesize_device)

__all__ = ['synthesize', 'sample', 'classify_route', 'ENGINES']

ENGINES = ('auto', 'cuda', 'cuda-dense', 'cuda-panel', 'cuda-sparse',
           'cuda-stack', 'native', 'torch', 'numpy')
_FORCE = {'cuda-dense': 'dense', 'cuda-panel': 'panel',
          'cuda-sparse': 'sparse', 'cuda-stack': 'stack'}


def classify_route(low, force=None, out_dtype=None, device=None):
    """Pick the kernel for a lowered schedule -> ``(kind, plan)``, kind in
    {'panel', 'sparse', 'stack', 'dense'}; ``plan`` is the PanelPlan,
    SparsePlan or StackPlan of that kind, None for 'dense'.

    The JAX package's rule (``waveforms_tpu.engine.classify_pallas_route``)
    step by step, with the thresholds of ``device``'s
    :class:`.ops.routes.RouteRule` (:func:`.ops.routes.rule_for`: the JAX
    package's for None or a CPU device, the H100's for a CUDA device).
    With occupancy, ``small`` and the schedule's size band the rule's
    (:func:`.ops.routes.facts`):

    1. occupancy at least the band's ``stack`` floor and not ``small``
       (:func:`.ops.routes.stack_first`): the stack kernel if the plan has
       >= ``stack_min_narrow`` narrow instances and an advantage >=
       ``stack_advantage``;
    2. ``small`` or occupancy < ``panel_occ``: the panel kernel, if it
       takes the plan (int16, bf16 and f16 need one bucket);
    3. occupancy below the band's ``worklist`` bound for the output's
       store, f32, a two-byte store or pair mode
       (:func:`.ops.routes.takes_worklist`): the worklist kernel;
    4. under the TPU's rule, the stack kernel on the merits of step 1, or
       for a schedule over the TPU's descriptor budget whose plan has no
       wide residual;
    5. the dense kernel.

    Two differences from the JAX rule, both because the card keeps
    descriptors and worklists in global memory:

    * 'panel-windowed' is 'panel' here: there is no worklist budget to
      window against, and the output is one buffer.
    * ``low.pallas_ok`` (the TPU's scalar-memory budget) refuses no forced
      engine here.  Under ``force=None`` the JAX rule still routes by it
      -- such a schedule skips steps 1-3, as a many-overlap schedule that
      the stack kernel serves best -- so that the routes agree; the
      card's rule does not.
    """
    if force not in (None, 'dense', 'panel', 'sparse', 'stack'):
        raise ValueError(f"unknown route {force!r}")
    if force == 'dense':
        return 'dense', None
    rule = rule_for(device)
    budget_ok = low.pallas_ok or not rule.tpu
    memo = []                       # build_stack_plan is O(instances)

    def stack_plan():
        if not memo:
            memo.append(build_stack_plan(low))
        return memo[0]

    sparse_plan = None
    if force in ('sparse', 'panel') or (force is None and budget_ok):
        try:
            sparse_plan = build_sparse_plan(low)
        except UnsupportedFactor:
            if force in ('sparse', 'panel'):
                raise
    if sparse_plan is not None:
        occ, small, band = facts(low, sparse_plan, rule)
        if (force is None and stack_first(occ, small, band)
                and stack_wins(stack_plan(), rule)):
            return 'stack', stack_plan()
        if force == 'panel' or (force is None and (
                small or occ < rule.panel_occ)):
            plan = build_panel_plan(low, base=sparse_plan)
            if panels_eligible(plan, normalize_out_dtype(out_dtype)):
                return 'panel', plan
            if force == 'panel':
                raise UnsupportedFactor(
                    "int16, bf16 and f16 panel output need a single-bucket "
                    "schedule")
        if force == 'sparse' or (force is None and takes_worklist(
                occ, band, store_kind(out_dtype, low.amp_im is not None))):
            return 'sparse', sparse_plan
    if force == 'stack' or (force is None and rule.tpu):
        p = stack_plan()
        if p is not None and (force == 'stack' or stack_wins(p, rule) or (
                not budget_ok and p.wide is None)):
            return 'stack', p
        if force == 'stack':
            raise UnsupportedFactor(
                "schedule has no batchable pulse instances")
    return 'dense', None


def _quantize_host(out, out_dtype, dac_scale):
    """Host-engine form of the kernels' stores, as the JAX package's
    ``engine._quantize_host``: int16 codes by scale -> round-half-even ->
    clip; f16 the float64 result rounded once (numpy ``astype``); bf16 as
    ``ml_dtypes``' ``astype`` rounds it (through f32), returned as a CPU
    ``torch.bfloat16`` tensor since numpy has no bf16 type.  A tensor (the
    ``'torch'`` engine's) is quantized on its device the same way, f16 and
    bf16 by ``Tensor.to``."""
    dt = normalize_out_dtype(out_dtype)
    if dt == torch.float32:
        return out
    if isinstance(out, torch.Tensor):
        if dt != torch.int16:
            return out.to(dt)
        sc = torch.as_tensor(np.asarray(dac_scale, np.float64),
                             device=out.device)
        scaled = out * (sc.reshape(-1, 1) if sc.ndim else sc)
        return torch.clamp(torch.round(scaled), -32768.0,
                           32767.0).to(torch.int16)
    if dt == torch.float16:
        return np.asarray(out).astype(np.float16)
    if dt == torch.bfloat16:
        return torch.from_numpy(np.ascontiguousarray(out)).to(dt)
    sc = np.asarray(dac_scale, np.float64)
    scaled = out * (sc.reshape(-1, 1) if sc.ndim else float(sc))
    return np.clip(np.round(scaled), -32768.0, 32767.0).astype(np.int16)


def _synthesize_numpy(channels, start, stop, sample_rate, part):
    from .core import WaveVStack
    t = np.arange(start, stop, 1 / sample_rate)
    # WaveVStack.__call__ returns the REAL part; 'imag' and 'complex' go
    # through the stack's complex accumulation, as the descriptor engines
    # lower it
    vals = [np.asarray((ch.simplify() if part != 'real'
                        and isinstance(ch, WaveVStack) else ch)(t))
            for ch in channels]
    if part == 'complex':
        return np.stack([v.astype(complex) for v in vals])
    return np.stack([np.real(v) if part == 'real' else np.imag(v)
                     for v in vals])


def _synthesize_torch(channels, start, stop, sample_rate, part, dt,
                      dac_scale, device):
    """The trace engine: every channel over the float64 grid on ``device``
    in one launch of T1 (JAX: engine ``'xla'``), quantized there."""
    from .core import WaveVStack
    from .ops.torch_eval import evaluate_channels
    device = resolve_device(device)
    # the grid as the oracle and JAX make it: numpy's arange, uploaded
    t = torch.from_numpy(np.arange(start, stop, 1 / sample_rate)).to(device)
    chans = [ch.simplify() if part != 'real' and isinstance(ch, WaveVStack)
             else ch for ch in channels]
    return _quantize_host(evaluate_channels(chans, t, part), dt, dac_scale)


def _synthesize_double(channels, start, stop, sample_rate, engine,
                       bucket_samples, part, device):
    """The double tier on 'auto', 'cuda' or 'cuda-dense' -> float64 (C, N)
    on ``device``.  Only the HiSchedule gates' UnsupportedFactor (complex
    part, opcodes outside HI_OPS), raised before any upload, sends 'auto' to
    the numpy oracle (returned as a tensor on ``device``), as the JAX engine
    sends such a schedule to its host f64 engines; a build, launch or device
    fault always propagates."""
    device = resolve_device(device)
    low = lower_schedule(channels, start, stop, sample_rate, part=part,
                         bucket_samples=bucket_samples, keep_f64=True)
    try:
        check_hi_schedule(low)
    except UnsupportedFactor:
        if engine != 'auto':
            raise
        return torch.from_numpy(_synthesize_numpy(
            channels, start, stop, sample_rate, part)).to(device)
    if engine == 'cuda-dense':
        return synthesize_hi(low, device=device)
    return synthesize_hi_routed(low, device=device)


def synthesize(channels, start: float, stop: float, sample_rate: float,
               engine: str = 'auto', bucket_samples='auto',
               part: str = 'real', precision: str = 'single',
               out_dtype=None, dac_scale=32767.0, device='cuda'):
    """Synthesize a list of channels -> (C, N), in the JAX package's
    argument order (``waveforms_tpu.engine.synthesize``), then ``device``.

    Returns a torch tensor on ``device`` for the kernel engines: f32, or
    with ``out_dtype=torch.int16`` (or ``np.int16``) DAC codes
    ``clip(round_half_even(x * dac_scale))`` with ``dac_scale`` a scalar or
    per-channel vector, with ``out_dtype=torch.bfloat16`` / ``float16``
    the f32 sum rounded once (``dac_scale`` ignored), or with
    ``part='complex'`` a complex64 tensor from one pair-mode pass (f32
    only).  ``precision='single'`` is the f32 tier;
    ``'double'`` is the <= 1e-9 tier and returns float64 (the double tier
    computes real parts only: under ``engine='auto'`` a complex part, or an
    opcode outside ``HI_OPS``, goes to the numpy oracle, and on the other
    engines raises ``UnsupportedFactor``).  ``engine='numpy'`` returns the
    float64 oracle as an ndarray (quantized the same way for int16,
    narrowed by ``astype`` for f16; bf16 as a CPU ``torch.bfloat16``
    tensor, numpy having no such type).  ``engine='native'`` returns the
    C++ host engine's float64 result as an ndarray (complex128 for
    ``part='complex'``), quantized as ``'numpy'``'s; ``engine='torch'``
    returns the trace evaluator's float64 (complex128) tensor on
    ``device``, quantized there.  An explicit f32 ``out_dtype`` is the
    default on every engine, as JAX maps it to None: these three keep
    float64.  Any ``out_dtype`` with ``precision='double'`` raises, as in
    JAX.
    ``device='cuda'`` without a GPU raises; nothing falls back to the CPU.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if part not in ('real', 'imag', 'complex'):
        raise ValueError(f"unknown part {part!r}")
    if precision not in ('single', 'double'):
        raise ValueError(f"unknown precision {precision!r}")
    dt = normalize_out_dtype(out_dtype)
    if precision == 'double':
        if out_dtype is not None:
            raise ValueError("out_dtype narrowing contradicts "
                             "precision='double'")
        if engine in ('cuda-panel', 'cuda-sparse', 'cuda-stack'):
            raise ValueError(
                f"precision='double' is unsupported on engine {engine!r}")
        if engine not in ('numpy', 'native', 'torch'):
            return _synthesize_double(channels, start, stop, sample_rate,
                                      engine, bucket_samples, part, device)
    if part == 'complex' and dt != torch.float32:
        raise ValueError("part='complex' requires f32 output")
    if engine == 'numpy':
        out = _synthesize_numpy(channels, start, stop, sample_rate, part)
        return _quantize_host(out, dt, dac_scale)
    if engine == 'native':
        from . import native
        # part='complex' lowers once with both amplitude planes and runs
        # one pair-mode pass
        low = lower_schedule(channels, start, stop, sample_rate, part=part,
                             bucket_samples=bucket_samples)
        return _quantize_host(native.synthesize_native(low), dt, dac_scale)
    if engine == 'torch':
        return _synthesize_torch(channels, start, stop, sample_rate, part,
                                 dt, dac_scale, device)
    device = resolve_device(device)
    low = lower_schedule(channels, start, stop, sample_rate, part=part,
                         bucket_samples=bucket_samples)
    kind, plan = classify_route(low, force=_FORCE.get(engine), out_dtype=dt,
                                device=device)
    if kind == 'stack':
        return synthesize_stack(low, plan, out_dtype=dt, dac_scale=dac_scale,
                                device=device)
    dev = DeviceSchedule(low, device)
    if kind == 'panel':
        return synthesize_panels(dev, plan=plan, out_dtype=dt,
                                 dac_scale=dac_scale)
    if kind == 'sparse':
        return synthesize_sparse(dev, plan=plan, out_dtype=dt,
                                 dac_scale=dac_scale)
    return synthesize_device(dev, out_dtype=dt, dac_scale=dac_scale)


def sample(wav, sample_rate=None, engine: str = 'auto', device='cuda'):
    """Engine-selected analog of ``Waveform.sample()``, in the JAX
    package's argument order (``waveforms_tpu.engine.sample``), then
    ``device``.

    SOS filters attached to the waveform (``wav.filters = (sos,
    initial)``) apply on ``device`` in the synthesized signal's dtype for
    the kernel engines and ``'torch'`` (:func:`.ops.iir.iir_apply`: the
    recurrence kernel S1 on the card; on the CPU JAX's route, the doubling
    scan or, where that is unstable, S1) and
    with scipy on the host for ``engine='numpy'`` and ``'native'``, which
    return an ndarray.
    """
    if sample_rate is None:
        sample_rate = wav.sample_rate
    if wav.start is None or wav.stop is None or sample_rate is None:
        raise ValueError('Waveform is not initialized')
    sig = synthesize([wav], wav.start, wav.stop, sample_rate,
                     engine=engine, device=device)[0]
    if wav.filters is None:
        return sig
    sos, initial = wav.filters
    if isinstance(sig, np.ndarray):
        from scipy.signal import sosfilt as _sosfilt
        sos = np.asarray(sos, dtype=float)
        if initial:
            return _sosfilt(sos, sig - initial) + initial
        return _sosfilt(sos, sig)
    from .ops.iir import iir_apply
    # the coefficients are rounded to the signal's dtype (f32 from the
    # kernel engines, f64 from 'torch'), as JAX casts them (routing reads
    # the rounded ones)
    sos = np.asarray(sos, dtype=float)
    if sig.dtype == torch.float32:
        sos = sos.astype(np.float32)
    return iir_apply(sos, sig, initial, device=sig.device)
