from .mixing import D, mixing
from .multy_drag import drag_sin, drag_sinx
from .shapes import (chirp, cos, cosh, coshPulse, cosPulse, cut, drag, exp,
                     function, gaussian, general_cosine, hanning, interp,
                     mollifier, poly, samplingPoints, sign, sin, sinc, sinh,
                     slepian, square, step, t)

__all__ = [
    'D', 'mixing', 'drag_sin', 'drag_sinx', 'chirp', 'cos', 'cosh',
    'coshPulse', 'cosPulse', 'cut', 'drag', 'exp', 'function', 'gaussian',
    'general_cosine', 'hanning', 'interp', 'mollifier', 'poly',
    'samplingPoints', 'sign', 'sin', 'sinc', 'sinh', 'slepian', 'square',
    'step', 't',
]
