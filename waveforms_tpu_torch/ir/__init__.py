"""Lazy symbolic IR for piecewise sums-of-products of analytic basis funcs.

Layer map (cf. SURVEY.md section 1): this package is L2 of the stack -- the
expression algebra, basis-function registry, symbolic calculus, trig
canonicalization, piecewise mergers, and the numpy oracle evaluator.  Device
execution lives in :mod:`waveforms_tpu.ops`.
"""

from .algebra import (HALF, NDIGITS, ONE, PI, TWO, ZERO, add, basic_wave,
                      const, is_const, mul, pow, shift)
from .calculus import D as D_expr
from .canonical import filter, simplify
from .piecewise import calc_parts, merge_piecewise, wave_sum
from .registry import (COS, COSH, D_GAUSSIAN, DRAG, ERF, EXP,
                       EXPONENTIALCHIRP, GAUSSIAN, HYPERBOLICCHIRP, INTERP,
                       LINEAR, LINEARCHIRP, MOLLIFIER, SINC, SINH, baseFunc,
                       baseFuncLatex, derivativeBaseFunc, hermite_coefficients,
                       mollifier_poly, packBaseFunc, registerBaseFunc,
                       registerBaseFuncLatex, registerDerivative,
                       updateBaseFunc)

__all__ = [
    "NDIGITS", "ZERO", "ONE", "HALF", "TWO", "PI",
    "add", "mul", "pow", "shift", "const", "basic_wave", "is_const",
    "D_expr", "simplify", "filter", "merge_piecewise", "wave_sum",
    "calc_parts",
    "LINEAR", "GAUSSIAN", "ERF", "COS", "SINC", "EXP", "INTERP",
    "LINEARCHIRP", "EXPONENTIALCHIRP", "HYPERBOLICCHIRP", "COSH", "SINH",
    "DRAG", "MOLLIFIER", "D_GAUSSIAN",
    "baseFunc", "baseFuncLatex", "derivativeBaseFunc",
    "registerBaseFunc", "registerDerivative", "registerBaseFuncLatex",
    "packBaseFunc", "updateBaseFunc", "hermite_coefficients",
    "mollifier_poly",
]
