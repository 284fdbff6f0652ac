"""Host lowering, plans and the synthesis entry points over the kernels.

Submodules are imported where they are used; the double tier's entry
points (:mod:`.hi_synth`), the sequence tables (:mod:`.sequencer`,
:mod:`.stack_seq`) and the signal chain -- IIR filtering (:mod:`.iir`),
FFT pipelines (:mod:`.fft`, and over a mesh axis :mod:`.fft_sharded`),
readout demodulation (:mod:`.demod`) and streaming synthesis
(:mod:`.streaming`) -- and the trace evaluator (:mod:`.torch_eval`) are
exported here.
"""

from .demod import demod_matrix, demodulate
from .fft import (correct_reflection_device, extract_kernel_device,
                  fft_convolve_centered, reflection_device)
from .fft_sharded import fft_convolve_sharded
from .hi_synth import (HI_OPS, HiSchedule, classify_hi_route,
                       synthesize_hi, synthesize_hi_panels,
                       synthesize_hi_routed)
from .iir import filter_zpk, iir_apply, lfilter, predistort_device, sosfilt
from .sequencer import Sequencer
from .stack_seq import StackSequencer
from .streaming import synthesize_stream
from .torch_eval import compile_waveform, evaluate, sample_waveform

__all__ = ['HI_OPS', 'HiSchedule', 'classify_hi_route', 'synthesize_hi',
           'synthesize_hi_panels', 'synthesize_hi_routed', 'Sequencer',
           'StackSequencer', 'sosfilt', 'lfilter', 'filter_zpk',
           'iir_apply', 'predistort_device', 'fft_convolve_centered',
           'fft_convolve_sharded',
           'reflection_device', 'correct_reflection_device',
           'extract_kernel_device', 'demod_matrix', 'demodulate',
           'synthesize_stream', 'compile_waveform', 'evaluate',
           'sample_waveform']
