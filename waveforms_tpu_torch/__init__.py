"""waveforms_tpu_torch: the PyTorch/CUDA port of waveforms_tpu.

The same lazy symbolic waveform IR and host lowering as ``waveforms_tpu``
(carried over, numpy only), synthesized on an NVIDIA GPU by hand-written
CUDA kernels over the flat descriptor tensors: a dense grid kernel, a
panel kernel and a worklist kernel that walk only the live subtiles of
pulse-sparse schedules, a stack kernel over pulse instances, and the double
tier's float64 dense and panel kernels (``precision='double'``); the C++
host engine (:mod:`.native`, whose walker also lowers the IR) and the trace
evaluator (:mod:`.ops.torch_eval`) beside them.  The
signal chain -- IIR pre-compensation, FFT deconvolution, readout
demodulation, streaming synthesis and the shot pipeline -- runs on the card
too (:mod:`.ops`, :mod:`.parallel`), with a recurrence kernel where the
doubling scan is unstable.  Every kernel has a plain PyTorch version beside
it (:mod:`.ops.reference`, :mod:`.ops.reference_hi`,
:mod:`.ops.reference_iir`), which runs for tensors on the CPU.

This package imports ``torch`` and numpy, never ``jax``.
"""

from numpy import e, pi

from .core import Waveform, WaveVStack, const, one, play, zero
from .dsl import wave_eval
from .engine import classify_route, sample, synthesize
from .ir.registry import registerBaseFunc, registerDerivative
from .models import (D, chirp, cos, cosh, coshPulse, cosPulse, cut, drag,
                     drag_sin, drag_sinx, exp, function, gaussian,
                     general_cosine, hanning, interp, mixing, mollifier, poly,
                     samplingPoints, sign, sin, sinc, sinh, slepian, square,
                     step, t)
from .ops.hi_synth import (HI_OPS, HiSchedule, classify_hi_route,
                           synthesize_hi, synthesize_hi_panels,
                           synthesize_hi_routed)
from .ops.lowering import UnsupportedFactor
from .version import __version__

__all__ = [
    'D', 'HI_OPS', 'HiSchedule', 'UnsupportedFactor', 'Waveform',
    'WaveVStack', 'chirp', 'classify_hi_route', 'classify_route', 'const',
    'cos', 'cosh', 'coshPulse', 'cosPulse', 'cut',
    'drag', 'drag_sin', 'drag_sinx', 'e', 'exp', 'function', 'gaussian',
    'general_cosine', 'hanning', 'interp', 'mixing', 'mollifier', 'one', 'pi',
    'play', 'poly', 'registerBaseFunc', 'registerDerivative', 'sample',
    'samplingPoints',
    'sign', 'sin', 'sinc', 'sinh', 'slepian', 'square', 'step', 'synthesize',
    'synthesize_hi', 'synthesize_hi_panels', 'synthesize_hi_routed', 't',
    'wave_eval', 'zero', '__version__',
]
