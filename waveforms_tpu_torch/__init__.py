"""waveforms_tpu_torch: the PyTorch/CUDA port of waveforms_tpu.

The same lazy symbolic waveform IR and host lowering as ``waveforms_tpu``
(carried over, numpy only), synthesized on an NVIDIA GPU by hand-written
CUDA kernels over the flat descriptor tensors: a dense grid kernel and a
panel kernel that walks only the live subtiles of pulse-sparse schedules.
Every kernel has a plain PyTorch version beside it (:mod:`.ops.reference`),
which runs for tensors on the CPU.

This package imports ``torch`` and numpy, never ``jax``.
"""

from numpy import e, pi

from .core import Waveform, WaveVStack, const, one, zero
from .engine import classify_route, synthesize
from .ir.registry import registerBaseFunc, registerDerivative
from .models import (D, chirp, cos, cosh, coshPulse, cosPulse, cut, drag,
                     drag_sin, drag_sinx, exp, function, gaussian,
                     general_cosine, hanning, interp, mixing, mollifier, poly,
                     samplingPoints, sign, sin, sinc, sinh, slepian, square,
                     step, t)
from .ops.lowering import UnsupportedFactor

__all__ = [
    'D', 'UnsupportedFactor', 'Waveform', 'WaveVStack', 'chirp',
    'classify_route', 'const', 'cos', 'cosh', 'coshPulse', 'cosPulse', 'cut',
    'drag', 'drag_sin', 'drag_sinx', 'e', 'exp', 'function', 'gaussian',
    'general_cosine', 'hanning', 'interp', 'mixing', 'mollifier', 'one', 'pi',
    'poly', 'registerBaseFunc', 'registerDerivative', 'samplingPoints',
    'sign', 'sin', 'sinc', 'sinh', 'slepian', 'square', 'step', 'synthesize',
    't', 'zero',
]
