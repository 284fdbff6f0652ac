"""LaTeX pretty-printing of IR expressions (notebook ``_repr_latex_``).

Recognizes "special" constants (rational multiples of 1, sqrt(2/3/5),
log(2/3/5), e, pi, pi^2, sqrt(pi)) via Fraction.limit_denominator, like the
reference (``feihoo87/waveforms/waveforms/waveform.py:21-122,899-1052``).
Formatters for the built-in basis functions register here; unknown basis IDs
render generically instead of raising.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from ..ir.algebra import ZERO, is_const
from ..ir.registry import (COS, COSH, D_GAUSSIAN, DRAG, ERF, EXP, GAUSSIAN,
                           LINEAR, MOLLIFIER, SINC, SINH, baseFuncLatex,
                           registerBaseFuncLatex)

_SPECIALS = [(1, ''), (np.sqrt(2), '\\sqrt{2}'), (np.sqrt(3), '\\sqrt{3}'),
             (np.sqrt(5), '\\sqrt{5}'), (np.log(2), '\\log{2}'),
             (np.log(3), '\\log{3}'), (np.log(5), '\\log{5}'), (np.e, 'e'),
             (np.pi, '\\pi'), (np.pi**2, '\\pi^2'),
             (np.sqrt(np.pi), '\\sqrt{\\pi}')]


def _as_small_fraction(num, spec):
    """Try num/spec then num*spec as a fraction with denominator <= 24."""
    x = Fraction(num / spec).limit_denominator(1000000000)
    if x.denominator <= 24:
        return True, x, 1
    x = Fraction(spec * num).limit_denominator(1000000000)
    if x.denominator <= 24:
        return True, x, -1
    return False, x, 0


def _sci(s: str) -> str:
    if "e" in s:
        mantissa, exponent = s.split("e")
        return f"{mantissa} \\times 10^{{{float(exponent):g}}}"
    return s


def _real_latex(num: float) -> str:
    for spec, spec_latex in _SPECIALS:
        ok, x, sign = _as_small_fraction(num, spec)
        if not ok:
            continue
        if sign < 0:
            spec_latex = f"\\frac{{{1}}}{{{spec_latex}}}"
        if x.denominator == 1:
            if x.numerator == 1:
                return f"{spec_latex}"
            return f"{_sci(f'{x.numerator:g}')}{spec_latex}"
        if x.numerator < 0:
            return f"-\\frac{{{-x.numerator}}}{{{x.denominator}}}{spec_latex}"
        return f"\\frac{{{x.numerator}}}{{{x.denominator}}}{spec_latex}"
    return _sci(f"{num:g}")


def num_latex(num) -> str:
    if num == -np.inf:
        return r"-\infty"
    if num == np.inf:
        return r"\infty"
    num = complex(num)
    if num.imag > 0:
        return f"\\left({num_latex(num.real)}+{num_latex(num.imag)}j\\right)"
    if num.imag < 0:
        return f"\\left({num_latex(num.real)}-{num_latex(-num.imag)}j\\right)"
    s = _real_latex(num.real)
    if s == '' and round(num.real) == 1:
        return '1'
    return s


def _factor_latex(factor) -> str:
    fun_id, *args, shift = factor
    formatter = baseFuncLatex.get(fun_id)
    if formatter is None:
        s = num_latex(shift)
        if s == "0":
            s = ""
        elif s[0] != '-':
            s = "+" + s
        return r"\mathrm{Func}" + f"{fun_id}(t{s}, ...)"
    return formatter(shift, *args)


def expr_latex(expr) -> str:
    """Render one IR expression."""
    if expr == ZERO:
        return "0"
    if is_const(expr):
        return f"{expr[1][0]}"

    rendered = []
    for term, amp in zip(*expr):
        if term == ((), ()):
            rendered.append(num_latex(amp))
            continue
        pieces = []
        amp_str = num_latex(amp)
        if amp_str != "1":
            pieces.append(amp_str)
        for factor, n in zip(*term):
            s = _factor_latex(factor)
            pieces.append(s if n == 1 else s + "^{" + f"{n}" + "}")
        rendered.append(''.join(pieces))

    out = rendered[0]
    for s in rendered[1:]:
        out += s if s[0] == '-' else "+" + s
    return out


# -- formatters for built-in bases ------------------------------------------


def _shift_suffix(shift) -> str:
    s = num_latex(-shift)
    if s == '0':
        return ''
    if s[0] != '-':
        return '+' + s
    return s


def _fmt_linear(shift, *args):
    suffix = _shift_suffix(shift)
    return f"(t{suffix})" if suffix else 't'


def _fmt_gaussian(shift, *args):
    sigma = num_latex(args[0] / np.sqrt(2))
    suffix = _shift_suffix(shift)
    if suffix:
        if sigma == '1':
            return ('\\exp\\left[-\\frac{\\left(t' + suffix +
                    '\\right)^2}{2}\\right]')
        return ('\\exp\\left[-\\frac{1}{2}\\left(\\frac{t' + suffix + '}{' +
                sigma + '}\\right)^2\\right]')
    if sigma == '1':
        return '\\exp\\left(-\\frac{t^2}{2}\\right)'
    return ('\\exp\\left[-\\frac{1}{2}\\left(\\frac{t}{' + sigma +
            '}\\right)^2\\right]')


def _fmt_sinc(shift, *args):
    suffix = _shift_suffix(shift)
    bw = num_latex(args[0])
    if suffix:
        if bw == '1':
            return '\\mathrm{sinc}(t' + suffix + ')'
        return '\\mathrm{sinc}[' + bw + '(t' + suffix + ')]'
    if bw == '1':
        return '\\mathrm{sinc}(t)'
    return '\\mathrm{sinc}(' + bw + 't)'


def _fmt_cos(shift, *args):
    freq = args[0] / 2 / np.pi
    phase = -shift * freq
    freq_s = num_latex(freq)
    if freq_s == '1':
        freq_s = ''
    phase_s = num_latex(phase)
    if phase_s == '0':
        phase_s = ''
    elif phase_s[0] != '-':
        phase_s = '+' + phase_s
    if phase_s != '':
        return f'\\cos\\left[2\\pi\\left({freq_s}t{phase_s}\\right)\\right]'
    if freq_s != '':
        return f'\\cos\\left(2\\pi\\times {freq_s}t\\right)'
    return '\\cos\\left(2\\pi t\\right)'


def _fmt_scaled_arg(name: str, shift, scale) -> str:
    """Render ``name(\\frac{t -/+ shift}{scale})``."""
    if shift > 0:
        arg = '\\frac{t-' + f"{num_latex(shift)}" + '}{' + f'{scale:g}' + '}'
    elif shift < 0:
        arg = '\\frac{t+' + f"{num_latex(-shift)}" + '}{' + f'{scale:g}' + '}'
    else:
        arg = '\\frac{t}{' + f'{scale:g}' + '}'
    return name + '(' + arg + ')'


def _fmt_erf(shift, *args):
    return _fmt_scaled_arg('\\mathrm{erf}', shift, args[0])


def _fmt_cosh(shift, *args):
    return _fmt_scaled_arg('\\cosh', shift, 1 / args[0])


def _fmt_sinh(shift, *args):
    return _fmt_scaled_arg('\\sinh', shift, args[0])


def _fmt_exp(shift, *args):
    if num_latex(shift) and shift > 0:
        return ('\\exp\\left(-' + f'{args[0]:g}' + '\\left(t-' +
                f"{num_latex(shift)}" + '\\right)\\right)')
    if num_latex(-shift) and shift < 0:
        return ('\\exp\\left(-' + f'{args[0]:g}' + '\\left(t+' +
                f"{num_latex(-shift)}" + '\\right)\\right)')
    return '\\exp\\left(-' + f'{args[0]:g}' + 't\\right)'


def _fmt_drag(shift, *args):
    return "DRAG(...)"


def _fmt_mollifier(shift, *args):
    r = num_latex(args[0])
    d = num_latex(args[1])
    suffix = _shift_suffix(shift)
    if d == '0':
        return f"\\mathrm{{Mollifier}}\\left(t{suffix}, r={r}\\right)"
    if d == '1':
        return f"\\mathrm{{Mollifier}}'\\left(t{suffix}, r={r}\\right)"
    if d == '2':
        return f"\\mathrm{{Mollifier}}''\\left(t{suffix}, r={r}\\right)"
    return f"\\mathrm{{Mollifier}}^{{({d})}}\\left(t{suffix}, r={r}\\right)"


def _fmt_d_gaussian(shift, *args):
    sigma = num_latex(args[0] / np.sqrt(2))
    d = args[1]
    suffix = _shift_suffix(shift)
    base = f"\\mathrm{{Gaussian}}\\left(t{suffix}, \\sigma={sigma}\\right)"
    if d == 0:
        return base
    if d == 1:
        return "\\frac{\\mathrm{d}}{\\mathrm{d}t}" + base
    return (f"\\frac{{\\mathrm{{d}}^{{{d}}}}}{{\\mathrm{{d}}t^{{{d}}}}}" +
            base)


registerBaseFuncLatex(LINEAR, _fmt_linear)
registerBaseFuncLatex(GAUSSIAN, _fmt_gaussian)
registerBaseFuncLatex(ERF, _fmt_erf)
registerBaseFuncLatex(COS, _fmt_cos)
registerBaseFuncLatex(SINC, _fmt_sinc)
registerBaseFuncLatex(EXP, _fmt_exp)
registerBaseFuncLatex(COSH, _fmt_cosh)
registerBaseFuncLatex(SINH, _fmt_sinh)
registerBaseFuncLatex(DRAG, _fmt_drag)
registerBaseFuncLatex(MOLLIFIER, _fmt_mollifier)
registerBaseFuncLatex(D_GAUSSIAN, _fmt_d_gaussian)
