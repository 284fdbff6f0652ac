"""The trace evaluator: the IR evaluated in plain torch float64 on a device.

The port of the JAX package's ``ops/jax_eval.py`` (its engine ``'xla'``,
here ``synthesize(..., engine='torch')``).  ``compile_waveform`` walks the
(hashable) IR once and returns a function of the sample grid: every segment
becomes a mask-select over the whole grid, every term a multiply-add, every
factor a call into the tensor lowerings of :mod:`.torch_basis`.  It runs
eagerly, one torch operation after another (JAX fuses the same program into
one XLA pass): there is no hand-written kernel here, and no
``torch.compile``.

The cache is keyed on the IR tuples themselves (nested tuples, hence
hashable); structurally equal waveforms share one evaluator.  The grid is a
float64 tensor (complex128 results where the IR is complex) on any device;
it does not need to be sorted: segment membership is evaluated per point
(``bounds[i-1] <= t < bounds[i]``), which on sorted grids coincides with the
oracle's searchsorted semantics.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core import Waveform, WaveVStack
from ..ir.algebra import ZERO
from .synth import resolve_device
from .torch_basis import get_traceable

__all__ = ['compile_waveform', 'sample_waveform', 'evaluate', 'compile_expr']


def _complex_of(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def _expr_is_complex(expr) -> bool:
    return any(isinstance(v, complex) for v in expr[1])


def _eval_expr(expr, t, memo):
    """Evaluate one IR expression over the grid *t* (factor-dedup memoized)."""

    def factor_values(factor):
        hit = memo.get(factor)
        if hit is None:
            fun_id, *args, shift = factor
            hit = get_traceable(fun_id)(t - shift, *args)
            memo[factor] = hit
        return hit

    acc = None
    for (factors, powers), v in zip(*expr):
        prod = None
        for factor, n in zip(factors, powers):
            vals = factor_values(factor)
            vals = vals if n == 1 else vals ** n
            prod = vals if prod is None else prod * vals
        term = (v if prod is None else
                (prod * v if v != 1.0 else prod))
        acc = term if acc is None else acc + term
    if acc is None:
        return torch.zeros_like(t)
    if not isinstance(acc, torch.Tensor) or acc.shape != t.shape:
        dtype = (_complex_of(t.dtype) if torch.is_tensor(acc)
                 and acc.is_complex() or isinstance(acc, complex)
                 else t.dtype)
        acc = torch.as_tensor(acc, dtype=dtype,
                              device=t.device).expand(t.shape)
    return acc


@lru_cache(maxsize=4096)
def compile_expr(expr):
    """Evaluator for a single segment expression (unbounded support)."""

    def run(t):
        return _eval_expr(expr, t, {})

    return run


@lru_cache(maxsize=1024)
def compile_waveform(bounds, seq, vmin=-np.inf, vmax=np.inf):
    """Evaluator ``f(t) -> values`` for a piecewise waveform IR.

    Zero segments contribute nothing (no work is done for them); the
    remaining segments evaluate under their membership mask and clip to
    [vmin, vmax], matching the oracle's per-part ``np.clip``.
    """
    is_complex = any(_expr_is_complex(s) for s in seq if s != ZERO)
    lowers = (-np.inf,) + bounds[:-1]

    def evaluate_fn(t):
        memo: dict = {}
        out = None
        for lo, hi, expr in zip(lowers, bounds, seq):
            if expr == ZERO:
                continue
            vals = _eval_expr(expr, t, memo)
            if vmin != -np.inf or vmax != np.inf:
                vals = torch.clamp(vals, vmin, vmax)
            if lo == -np.inf and hi == np.inf:
                seg = vals
            else:
                mask = torch.ones(t.shape, dtype=torch.bool, device=t.device)
                if lo != -np.inf:
                    mask = mask & (t >= lo)
                if hi != np.inf:
                    mask = mask & (t < hi)
                seg = torch.where(mask, vals, 0)
            out = seg if out is None else out + seg
        if out is None:
            return torch.zeros(t.shape, dtype=t.dtype, device=t.device)
        if is_complex and not out.is_complex():
            out = out.to(_complex_of(t.dtype))
        return out

    return evaluate_fn


def evaluate(wav: Waveform, t) -> torch.Tensor:
    """Evaluate a Waveform (or WaveVStack) on the grid *t* (a tensor, or an
    array, which stays on the CPU)."""
    t = torch.as_tensor(t)
    if isinstance(wav, WaveVStack):
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
        out = torch.zeros(t.shape, dtype=_complex_of(t.dtype),
                          device=t.device) + wav.offset
        tt = t - wav.shift if wav.shift != 0 else t
        for bounds, seq in wav.wlist:
            # min/max passed explicitly: lru_cache keys omitted defaults
            # differently and would build identical evaluators twice
            out = out + compile_waveform(bounds, seq, -np.inf, np.inf)(tt)
        return out.real
    return compile_waveform(wav.bounds, wav.seq, wav.min, wav.max)(t)


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
