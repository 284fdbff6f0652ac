"""String expression DSL: ``wave_eval("gaussian(10) >> 5") -> Waveform``.

A self-contained tokenizer + precedence-climbing parser implementing the
reference grammar (``feihoo87/waveforms: waveforms/Waveform.g4``) with no
ANTLR/Java dependency.  Operator precedence follows the grammar's
alternative order exactly (ANTLR assigns tighter binding to earlier
alternatives, all left-associative by default):

    **  ^          power            (tightest, left-assoc -- 2**3**2 == 64)
    *   /          multiply/divide
    +   -          add/subtract
    <<  >>         time shift
    - (unary)      weakest: ``-a + b`` parses as ``-(a + b)``

Function names resolve against the public constructor namespace (shapes,
mixing, multi-tone DRAG, core); assignments and bare identifiers are
rejected, matching ``feihoo87/waveforms: waveforms/waveform_parser.py``.
"""

from __future__ import annotations

import importlib
import re
from ast import literal_eval
from functools import lru_cache

import numpy as np

from .. import core
from ..models import multy_drag as _multy_drag_mod
from ..models import shapes as _shapes_mod

# NB: `from ..models import mixing` would bind the re-exported mixing
# FUNCTION (models/__init__.py shadows the submodule attribute), leaving
# `D` and `mixing` unresolvable from expressions; import the module.
_mixing_mod = importlib.import_module('.models.mixing',
                                      __package__.rsplit('.', 1)[0])

__all__ = ['wave_eval', 'parse_waveform_expression', 'WaveformParseError']


class WaveformParseError(Exception):
    """Raised on any lexical, syntactic, or resolution error."""


_TOKEN_RE = re.compile(r"""
    (?P<WS>\s+)
  | (?P<IMAG>(\d+\.\d*|\.\d+|\d+\.?)([eE][+-]?\d+)?j)
  | (?P<NUMBER>(\d+\.\d*|\.\d+|\d+\.?)([eE][+-]?\d+)?)
  | (?P<STRING>"[^"\r\n]*"|'[^'\r\n]*')
  | (?P<ID>[a-zA-Z_][a-zA-Z0-9_]*)
  | (?P<OP>\*\*|<<|>>|[\^*/+\-()\[\],=])
""", re.VERBOSE)

_CONSTANTS = {'pi': np.pi, 'e': np.e, 'inf': np.inf}

# Operator binding powers, from the grammar's alternative order.
_BINARY_PREC = {'**': 13, '^': 13, '*': 12, '/': 12, '+': 11, '-': 11,
                '<<': 10, '>>': 10}
_UNARY_MINUS_PREC = 8


def _tokenize(text: str):
    tokens = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise WaveformParseError(
                f"Unexpected character {text[pos]!r} at position {pos}")
        kind = m.lastgroup
        if kind != 'WS':
            tokens.append((kind, m.group(), pos))
        pos = m.end()
    tokens.append(('EOF', '', len(text)))
    return tokens


class _Parser:
    """Precedence-climbing parser producing the evaluated value directly."""

    def __init__(self, text: str):
        self.tokens = _tokenize(text)
        self.i = 0

    # -- token stream --------------------------------------------------------

    def peek(self, ahead=0):
        j = min(self.i + ahead, len(self.tokens) - 1)
        return self.tokens[j]

    def next(self):
        tok = self.tokens[self.i]
        if tok[0] != 'EOF':
            self.i += 1
        return tok

    def expect(self, value):
        kind, text, pos = self.next()
        if text != value:
            raise WaveformParseError(
                f"Expected {value!r} at position {pos}, got {text!r}")

    def at(self, value) -> bool:
        return self.peek()[1] == value and self.peek()[0] in ('OP', 'ID')

    # -- grammar -------------------------------------------------------------

    def parse(self):
        # top-level: assignment | expression
        if (self.peek()[0] == 'ID' and self.peek(1)[0] == 'OP'
                and self.peek(1)[1] == '='):
            raise WaveformParseError(
                "Assignment expressions are not supported")
        value = self.expression(0)
        kind, text, pos = self.peek()
        if kind != 'EOF':
            raise WaveformParseError(
                f"Unexpected token {text!r} at position {pos}")
        return value

    def expression(self, min_prec: int):
        left = self.primary()
        while True:
            kind, text, _ = self.peek()
            prec = _BINARY_PREC.get(text) if kind == 'OP' else None
            if prec is None or prec < min_prec:
                return left
            self.next()
            right = self.expression(prec + 1)  # left-associative
            left = self.apply_binary(text, left, right)

    @staticmethod
    def apply_binary(op: str, left, right):
        if op in ('**', '^'):
            return left ** right
        if op == '*':
            return left * right
        if op == '/':
            return left / right
        if op == '+':
            return left + right
        if op == '-':
            return left - right
        if op == '<<':
            return left << right
        return left >> right

    def primary(self):
        kind, text, pos = self.peek()
        if kind == 'OP' and text == '-':
            self.next()
            return -self.expression(_UNARY_MINUS_PREC)
        if kind == 'OP' and text == '(':
            return self.parens_or_tuple()
        if kind == 'OP' and text == '[':
            return self.list_literal()
        if kind == 'IMAG':
            self.next()
            return literal_eval(text)
        if kind == 'NUMBER':
            self.next()
            return literal_eval(text)
        if kind == 'STRING':
            self.next()
            return literal_eval(text)
        if kind == 'ID':
            # 'pi'/'e'/'inf' always lex as constants (grammar priority).
            if text in _CONSTANTS:
                self.next()
                return _CONSTANTS[text]
            if self.peek(1)[0] == 'OP' and self.peek(1)[1] == '(':
                return self.function_call()
            raise WaveformParseError(f"Unknown identifier '{text}'")
        raise WaveformParseError(
            f"Unexpected token {text!r} at position {pos}")

    def parens_or_tuple(self):
        self.expect('(')
        first = self.expression(0)
        if self.at(')'):
            self.next()
            return first  # parenthesized expression
        items = [first]
        while self.at(','):
            self.next()
            if self.at(')'):  # single-element tuple "(x,)"
                if len(items) == 1:
                    self.next()
                    return (items[0],)
                raise WaveformParseError("Trailing comma in tuple")
            items.append(self.expression(0))
        self.expect(')')
        return tuple(items)

    def list_literal(self):
        self.expect('[')
        if self.at(']'):
            self.next()
            return []
        items = [self.expression(0)]
        while self.at(','):
            self.next()
            items.append(self.expression(0))
        self.expect(']')
        return items

    def function_call(self):
        _, name, _ = self.next()
        func = _resolve_function(name)
        self.expect('(')
        args: list = []
        kwargs: dict = {}
        if not self.at(')'):
            while True:
                if (self.peek()[0] == 'ID' and self.peek(1)[0] == 'OP'
                        and self.peek(1)[1] == '='):
                    _, key, _ = self.next()
                    self.next()  # '='
                    kwargs[key] = self.expression(0)
                elif kwargs:
                    raise WaveformParseError(
                        "Positional argument after keyword argument")
                else:
                    args.append(self.expression(0))
                if self.at(','):
                    self.next()
                    continue
                break
        self.expect(')')
        return func(*args, **kwargs)


# Explicit call whitelist, matching the reference's 29-name set
# (feihoo87/waveforms: waveforms/waveform_parser.py:30-36) plus the two public
# constructors it omits only because they postdate the grammar (slepian,
# function is deliberately NOT exposed: it registers arbitrary callables).
# Everything else -- including module imports reachable as attributes of
# the constructor modules (np, cast, ...) -- must NOT resolve.
_FUNCTIONS = frozenset([
    'D', 'chirp', 'const', 'cos', 'cosh', 'coshPulse', 'cosPulse',
    'cut', 'drag', 'drag_sin', 'drag_sinx', 'exp', 'gaussian',
    'general_cosine', 'hanning', 'interp', 'mixing', 'mollifier',
    'one', 'poly', 'samplingPoints', 'sign', 'sin', 'sinc', 'sinh',
    'slepian', 'square', 'step', 't', 'zero',
])


def _resolve_function(name: str):
    """Resolve a whitelisted callable from the constructor namespaces."""
    if name in _FUNCTIONS:
        for mod in (_shapes_mod, _mixing_mod, _multy_drag_mod, core):
            func = getattr(mod, name, None)
            if func is not None and callable(func):
                return func
    raise WaveformParseError(f"Unknown function '{name}'")


def parse_waveform_expression(expr: str) -> core.Waveform:
    """Parse and evaluate a waveform expression string."""
    try:
        result = _Parser(expr).parse()
        if isinstance(result, (int, float, complex)):
            result = core.const(result)
        return result.simplify()
    except WaveformParseError:
        raise
    except Exception as exc:  # evaluation errors surface uniformly
        raise WaveformParseError(
            f"Failed to parse expression '{expr}': {exc}")


@lru_cache(maxsize=1024)
def _wave_eval_cached(expr: str) -> core.Waveform:
    return parse_waveform_expression(expr)


def wave_eval(expr: str) -> core.Waveform:
    """Cached parse of a waveform expression; raises SyntaxError on failure.

    Expression hashability (the whole IR is nested tuples) makes the
    cache sound for the IR itself, but the HEADER slots (start/stop/
    sample_rate/filters/...) are mutable and callers routinely set them
    before sample() -- so every call returns a FRESH Waveform sharing
    the cached immutable bounds/seq (returning the identical object let
    two call sites clobber each other's sampling window through the
    cache)."""
    try:
        cached = _wave_eval_cached(expr)
    except Exception as exc:
        raise SyntaxError(f"Failed to parse expression '{expr}': {exc}")
    fresh = core.Waveform(cached.bounds, cached.seq, min=cached.min,
                          max=cached.max)
    return fresh
