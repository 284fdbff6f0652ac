"""Small waveforms on which the trace evaluator's kernel T1
(``csrc/trace_eval.cu``) and its plain version (:mod:`.reference_trace`)
are checked: by the tests, ``chip_smoke.py`` and the tools.  Nothing on the
main path uses them.

Each case builds its channels with the package given as ``w`` (the port,
or in the CPU tests the JAX package too, from the same constructors), so
both evaluate the same IR.  Between them the cases reach every built-in
basis (IDs 1 to 17), multi-tone DRAG, mixing, a clip, interp's edges,
powers 1 to 4 and the other kinds of ``POW_KINDS``, a ``WaveVStack`` with
an offset and a shift, a real and a complex user basis (external slots),
an unsorted grid, a float32 grid, a tape of several channels of
different structures, and built-ins with complex arguments (those that T1
evaluates itself, and a linear chirp with a complex phase, an external
slot filled on the grid's device).  The cases over 6,161 samples cross
T1's tiles of 2,048 samples (three tiles and a ragged tail): segment
bounds on tile edges and on a tile's first and last sample, a sorted grid
with repeated values and one descent in its middle tile, a shifted
``WaveVStack``, and a real and a complex tape over the same grid.
:data:`JAX_DECLINES` names the cases that the JAX package's evaluator
does not take.
"""

from __future__ import annotations

import numpy as np

__all__ = ['CASES', 'JAX_DECLINES', 'cases', 'user_real',
           'user_complex']


def user_real(t, a):
    """A user basis with no lowering (an external slot)."""
    return np.tanh(a * t)


def user_complex(t):
    """A complex-valued user basis (a complex external slot)."""
    return np.exp(1j * t)


def _mixing(w):
    pulse = w.cosPulse(20e-9)
    x = w.zero()
    for amp, dt, ph in [(0.5, 0, 0), (1.0, 1e-6, np.pi / 2), (0.5, 2e-6, 0)]:
        I, _ = w.mixing((amp * pulse) >> dt, freq=-20e6, phase=ph,
                        DRAGScaling=0.2)
        x += I
    return [x]


def _clip(w):
    wav = 2 * w.gaussian(4)
    wav.max, wav.min = 1.0, 0.5
    return [wav, 3 * w.cos(1.5) + 0.5]


def _clip_one_side(w):
    wav = 3 * w.cos(1.5) + 0.5
    wav.max = 1.0
    return [wav]


def _powers(w):
    g = w.gaussian(4)
    c = w.cos(0.7)
    return [g ** 2, g ** 3, c ** 4, (w.cos(1.0) + w.sin(2.0)) ** 2,
            (c + 1.5) ** 3, g ** -1, g ** -2, g ** 0.5, g ** -0.5,
            g ** 1.5, g * c ** 2]


def _vstack(w):
    wlist = [w.cos(1), w.sin(2), w.gaussian(3) >> 1, w.poly([1, -0.5, 0.1])]
    return [(w.WaveVStack(wlist) >> 0.25) + 0.5,
            w.WaveVStack([w.gaussian(2) >> -1, w.cosPulse(3)])]


def _user(w):
    return [w.function(user_real, 2.0, start=-1, stop=1),
            w.function(user_real, 3.0) * w.gaussian(4) >> 0.5]


def _user_complex(w):
    return [w.function(user_complex), 0.5 * w.function(user_complex)
            * w.cos(2.0) + w.gaussian(3)]


def _multi_channel(w):
    I, Q = w.mixing(0.5 * w.cosPulse(2.0) >> 1.0, freq=0.8,
                    DRAGScaling=0.1)
    return [I, Q, (1 + 0.5j) * w.gaussian(3) * w.cos(2.5) >> 2.0,
            w.square(4, edge=1) >> 3.0, w.zero(),
            w.WaveVStack([w.cosPulse(2) >> 3, 0.3 * w.gaussian(2) >> 9]),
            w.chirp(0.2, 1.0, 10, 0.3, 'linear') * w.mollifier(8.0, d=1)]


def _complex_args(w):
    reg, bw = w.ir.registry, w.ir.algebra.basic_wave

    def one(*factor, shift=0):
        return w.Waveform(seq=(bw(*factor, shift=shift),))
    return [one(reg.EXP, 2j * np.pi * 0.3),
            one(reg.EXP, -0.2 + 1.5j, shift=0.5) * w.gaussian(6),
            one(reg.COS, 0.7 + 0.2j), one(reg.COSH, 0.3 + 1.1j),
            one(reg.SINH, 0.25 - 0.8j), one(reg.SINC, 1.5 + 0.5j),
            one(reg.GAUSSIAN, 3 + 1j, shift=-1.0),
            one(reg.EXP, 0.5j) ** 2 + 0.5 * w.cos(2.0),
            one(reg.LINEARCHIRP, 1.0, 2.0, 10.0, 0.3 + 0.1j)]


def _interp_complex(w):
    return [w.samplingPoints(0.0, 10.0, (1 + 1j, 2 - 1j, 0.5j, -1.0, 3.0)),
            w.samplingPoints(1.0, 2.0, (0.25 - 0.5j,)) * w.cos(3.0)]


def _tile_edges(w):
    # the grid's samples are 0, 1, ..., 6160; T1's tiles start at 0, 2048,
    # 4096 and 6144: bounds at 2047 / 4096, 2048 / 6144 and 4095 / 6160
    a = w.cosPulse(2049.0) >> 3071.5
    b = 0.5 * w.cos(0.003) * (w.square(4096.0) >> 4096.0)
    c = w.square(2065.0) >> 5127.5
    return [a, b, c, a + c + (w.gaussian(100.0) >> 6144.0) + b * w.t()]


def _sorted_repeats_grid():
    grid = np.repeat(np.linspace(-3, 9, 2054), 3)[:6161].copy()
    grid[3000], grid[3003] = grid[3003], grid[3000]     # one descent
    return grid


def _vstack_tiles(w):
    rng = np.random.default_rng(17)
    members = [(0.5 * w.cosPulse(1.5) >> o) for o in rng.uniform(0, 58, 12)]
    return [(w.WaveVStack(members) >> 0.37) + 0.25,
            w.WaveVStack([w.gaussian(3) >> 20, w.cos(0.4) * w.square(8)
                          >> 44]) >> -1.25]


def _tiles_real_complex(w):
    wav = (w.cosPulse(3.0) >> 4.0) * w.cos(2.0) + 0.3 * (w.gaussian(1.0)
                                                         >> 10.0)
    return [wav, (1 + 0.5j) * wav]


LINSPACE = np.linspace(-6, 12, 4001)
TILES = np.linspace(-2, 14, 6161)       # three of T1's tiles and 17 more
DRAG_GRID = np.linspace(-10e-9, 50e-9, 2001)
MIXING_GRID = np.linspace(-1e-6, 9e-6, 10001)
_MULTI = dict(plateau=6e-9, delta=3e6, block_freq=(150e6, -80e6), phase=0.1)

#: name -> (channels of package w, grid, (rtol, atol) against the oracle,
#: the atol relative to the oracle's peak where True; None: no oracle
#: check -- interp's edges are jnp.interp's, not numpy's)
CASES = {
    'linear-poly': (lambda w: [w.poly([1.0, 0.5, -0.25]), w.t()], LINSPACE,
                    (1e-9, 1e-12)),
    'gaussian': (lambda w: [w.gaussian(4), w.gaussian(4, plateau=2)],
                 LINSPACE, (1e-9, 1e-12)),
    'erf': (lambda w: [w.square(2, edge=0.5), w.step(1.0)], LINSPACE,
            (1e-9, 1e-12)),
    'cos': (lambda w: [w.cos(3.0, 0.7), w.square(2, edge=0.5, type='cos')],
            LINSPACE, (1e-9, 1e-12)),
    'sinc': (lambda w: [w.sinc(1.5)], np.concatenate([LINSPACE, [0.0]]),
             (1e-9, 1e-12)),
    'exp': (lambda w: [w.exp(-0.3), w.exp(-0.3 + 2j)], LINSPACE,
            (1e-9, 1e-12)),
    'interp': (lambda w: [w.samplingPoints(0, 10,
                                           np.linspace(0, 10, 11) ** 2)],
               np.linspace(-1, 11, 500), (1e-9, 1e-12)),
    'interp-edges': (lambda w: [
        w.samplingPoints(0.0, 10.0, (1.0, -2.0, 0.5, 3.0, 3.0, -1.0)),
        w.samplingPoints(2.0, 2.0 + 1e-300, (1.0, -2.0, 0.5, 3.0)),
        w.samplingPoints(1.0, 2.0, (0.25,))],
        np.concatenate([np.linspace(-3, 13, 801), np.linspace(0, 10, 6),
                        [2.0, 2.0 + 1e-300, 1.0]]), (None, None)),
    'chirp-lin': (lambda w: [w.chirp(1, 2, 10, 0.3, 'linear')], LINSPACE,
                  (1e-9, 1e-12)),
    'chirp-exp': (lambda w: [w.chirp(1, 2, 10, 0.3, 'exponential')],
                  LINSPACE, (1e-9, 1e-12)),
    'chirp-hyp': (lambda w: [w.chirp(1, 2, 10, 0.3, 'hyperbolic')],
                  LINSPACE, (1e-9, 1e-12)),
    'cosh-sinh': (lambda w: [w.coshPulse(2.0, eps=3.0, plateau=1.0),
                             w.sinh(0.3), w.cosh(0.2)], LINSPACE,
                  (1e-9, 1e-12)),
    'drag': (lambda w: [w.drag(0.5, 2.0, plateau=1.0, delta=0.05,
                               block_freq=1.3, phase=0.2),
                        w.drag(0.5, 2.0, delta=0.05)], LINSPACE,
             (1e-9, 1e-12)),
    'mollifier': (lambda w: [w.mollifier(4.0, d=0), w.mollifier(4.0, d=1),
                             w.mollifier(4.0, plateau=1.0, d=2)], LINSPACE,
                  (1e-9, 1e-12)),
    'd-gaussian': (lambda w: [w.gaussian(4, d=2), w.gaussian(4, d=3),
                              w.D(w.gaussian(4) * w.cos(5.0))], LINSPACE,
                   (1e-9, 1e-12)),
    'drag-sin': (lambda w: [w.drag_sin(0.2e9, 22e-9, **_MULTI)], DRAG_GRID,
                 (1e-9, 1e-9)),
    'drag-sinx': (lambda w: [w.drag_sinx(0.2e9, 22e-9, tab=0.5, **_MULTI),
                             w.drag_sinx(0.2e9, 22e-9, plateau=0,
                                         delta=3e6, block_freq=150e6)],
                  DRAG_GRID, (1e-9, 1e-9)),
    'mixing': (_mixing, MIXING_GRID, (1e-9, True)),
    'clip': (_clip, np.linspace(-4, 4, 1001), (1e-9, 1e-12)),
    'clip-one-side': (_clip_one_side, np.linspace(-4, 4, 1001),
                      (1e-9, 1e-12)),
    'powers': (_powers, LINSPACE, (1e-9, 1e-12)),
    'vstack': (_vstack, np.linspace(-10, 10, 2001), (1e-9, 1e-12)),
    'user': (_user, np.linspace(-2, 2, 401), (1e-9, 1e-12)),
    'user-complex': (_user_complex, np.linspace(0, 1, 50), (2e-6, 1e-12)),
    'unsorted': (lambda w: [w.gaussian(4) + 0.5 * w.cos(7.0) * w.square(3),
                            w.cosPulse(2.0) >> 1],
                 np.random.default_rng(3).permutation(LINSPACE),
                 (1e-9, 1e-12)),
    'multi-channel': (_multi_channel, np.linspace(-2, 14, 3001),
                      (1e-9, 1e-12)),
    'complex-args': (_complex_args, np.concatenate([LINSPACE, [0.0]]),
                     (1e-9, 1e-12)),
    'interp-complex': (_interp_complex, np.linspace(-1, 11, 500),
                       (1e-9, 1e-12)),
    'tile-edges': (_tile_edges, np.arange(6161.0), (1e-9, 1e-12)),
    'sorted-repeats': (lambda w: [w.gaussian(2) >> 1,
                                  w.cos(1.3) * w.square(4) >> 4,
                                  w.cosPulse(0.5) >> 3.0],
                       _sorted_repeats_grid(), (1e-9, 1e-12)),
    'vstack-tiles': (_vstack_tiles, np.linspace(0, 60, 6161),
                     (1e-9, 1e-12)),
    'tiles-real-complex': (_tiles_real_complex, TILES, (1e-9, 1e-12)),
}

#: case -> why the JAX package's evaluator raises on it (the port and the
#: oracle evaluate it)
JAX_DECLINES = {'interp-complex': "jnp.interp casts its points to the "
                                  "grid's real type"}


def cases(w) -> dict:
    """{name: (channels built with package ``w``, grid, (rtol, atol))},
    the atol of 'mixing' scaled to its oracle's peak (~2.6e7)."""
    out = {}
    for name, (build, grid, (rtol, atol)) in CASES.items():
        chans = build(w)
        if atol is True:
            peak = max(np.abs(np.asarray(ch(grid))).max() for ch in chans)
            atol = 1e-9 * peak
        out[name] = (chans, grid, (rtol, atol))
    return out
