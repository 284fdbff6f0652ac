"""The trace evaluator: the IR evaluated in float64 on a device by kernel T1.

The port of the JAX package's ``ops/jax_eval.py`` (its engine ``'xla'``,
here ``synthesize(..., engine='torch')``).  JAX traces each waveform
structure once and jits it into one elementwise XLA program; here the IR
is flattened once into a trace tape (:mod:`.trace_tape`, cached by the IR
tuples and uploaded once per device) and every channel of a call is
evaluated in one launch of the hand-written kernel T1
(``csrc/trace_eval.cu``, :data:`..kernels.trace_eval`): per sample, a
binary search for the segment, that segment's terms and factors -- the
formulas of :mod:`.torch_basis` --, the clip.  On a CPU tensor the launch
is T1's plain version (:mod:`.reference_trace`), the same tape evaluated
segment by segment through ``torch_basis``'s lowerings; a CUDA tensor
always takes the kernel (a failed build or launch raises).

``compile_waveform`` and ``compile_expr`` return functions of the grid
that run their tape; structurally equal waveforms share one.  The grid is
a float64 (or float32) tensor on any device, complex results complex128
(complex64); it does not need to be sorted: segment membership is found
per point (``bounds[i-1] <= t < bounds[i]``), which on sorted grids
coincides with the oracle's searchsorted semantics.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core import Waveform, WaveVStack
from .synth import resolve_device
from .trace_tape import channel_key, run, tape_of

__all__ = ['compile_waveform', 'sample_waveform', 'evaluate',
           'evaluate_channels', 'compile_expr']


def _grid(t) -> torch.Tensor:
    """The grid as a flat float tensor (an integer grid as float64)."""
    t = torch.as_tensor(t)
    if not t.is_floating_point():
        t = t.to(torch.float64)
    return t.reshape(-1)


def _run_one(key, t) -> torch.Tensor:
    """One channel over the grid ``t`` (any shape), complex where the
    evaluator returns it complex."""
    t = torch.as_tensor(t)
    tape = tape_of((key,))
    out = run(tape, _grid(t), 'complex' if tape.complex[0] else 'real')
    return out[0].reshape(t.shape)


def compile_expr(expr):
    """Evaluator for a single segment expression (unbounded support); its
    tape is ``tape_of``'s, cached there."""
    key = ('w', (np.inf,), (expr,), -np.inf, np.inf)

    def run_expr(t):
        return _run_one(key, t)

    return run_expr


@lru_cache(maxsize=1024)
def compile_waveform(bounds, seq, vmin=-np.inf, vmax=np.inf):
    """Evaluator ``f(t) -> values`` for a piecewise waveform IR; structurally
    equal IR returns the same function, as JAX's does.

    Zero segments contribute nothing (no work is done for them); the
    remaining segments evaluate where the sample falls in them and clip to
    [vmin, vmax], matching the oracle's per-part ``np.clip``.
    """
    key = ('w', bounds, seq, vmin, vmax)

    def evaluate_fn(t):
        return _run_one(key, t)

    return evaluate_fn


def _check_function_lib(wav):
    if wav.function_lib is not None:
        # the evaluator resolves basis IDs against the GLOBAL registry;
        # a stack shipped from another process carries its own
        # function_lib, and a missing ID here would otherwise KeyError
        # (or, worse, collide with a local registration)
        from ..ir import registry as _reg
        missing = sorted(
            fid for fid in wav.function_lib
            if fid not in _reg.baseFunc)
        if missing:
            raise ValueError(
                f"stack carries user basis IDs {missing} not in this "
                "process's registry -- ship it with registry."
                "packBaseFunc()/updateBaseFunc() first (the trace "
                "engine resolves IDs globally)")


def evaluate(wav: Waveform, t) -> torch.Tensor:
    """Evaluate a Waveform (or WaveVStack, its real part) on the grid *t*
    (a tensor, or an array, which stays on the CPU): one T1 launch."""
    if isinstance(wav, WaveVStack):
        _check_function_lib(wav)
    return _run_one(channel_key(wav), t)


def evaluate_channels(channels, t, part='real') -> torch.Tensor:
    """Every channel over the 1-D grid ``t`` in one T1 launch -> (C, N):
    ``part`` 'real' or 'imag' in the grid's type (a real channel's
    imaginary part 0), 'complex' in its complex type."""
    for ch in channels:
        if isinstance(ch, WaveVStack):
            _check_function_lib(ch)
    tape = tape_of(tuple(channel_key(ch) for ch in channels))
    return run(tape, _grid(t), part)


def sample_waveform(wav: Waveform, sample_rate=None, dtype=None,
                    device='cuda') -> torch.Tensor:
    """Device analog of ``Waveform.sample()`` (incl. SOS filtering) on
    ``device``.

    The grid is ``np.arange(start, stop, 1 / sample_rate)`` made on the host
    (cast to ``dtype`` if given) and uploaded, as the JAX package and the
    oracle make it.  SOS filters run through :func:`.iir.iir_apply` in the
    signal's dtype.
    """
    if sample_rate is None:
        sample_rate = wav.sample_rate
    if wav.start is None or wav.stop is None or sample_rate is None:
        raise ValueError(
            f'Waveform is not initialized. {wav.start=}, {wav.stop=}, '
            f'{sample_rate=}')
    device = resolve_device(device)
    t = np.arange(wav.start, wav.stop, 1 / sample_rate)
    if dtype is not None:
        t = t.astype(dtype)
    sig = evaluate(wav, torch.from_numpy(t).to(device))
    if wav.filters is not None:
        from .iir import iir_apply
        sos, initial = wav.filters
        sos = np.asarray(sos, dtype=float)
        if sig.dtype == torch.float32:
            sos = sos.astype(np.float32)
        sig = iir_apply(sos, sig, initial, device=device)
    return sig
