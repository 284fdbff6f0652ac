"""The trace tape and T1's plain version (``ops/trace_tape.py``,
``ops/reference_trace.py``) against the JAX package's trace evaluator
(``ops/jax_eval.py``, engine ``'xla'``) under x64 on the CPU, and against
the numpy float64 oracle.

Every case of ``waveforms_tpu_torch.ops.trace_cases`` is built in both
packages from the same constructors; each channel goes through
``torch_eval.evaluate`` (a one-channel tape) and all of a case's channels
through one multi-channel tape (``evaluate_channels``, as
``synthesize(engine='torch')`` takes them), on the CPU, where the kernel
wrapper runs T1's plain version.  Bounds: 1e-12 of each channel's peak
against JAX in float64 (a float32 grid: 1e-6, the repo's f32 bound -- two
float32 libraries' sin and exp differ by ulps), and the JAX suite's rtol
1e-9 / atol 1e-12 against the oracle (a complex user basis 2e-6, the JAX
suite's own; mixing and multi-tone DRAG at the JAX suite's atol).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import waveforms_tpu as wj
import waveforms_tpu_torch as wt
from waveforms_tpu.ops import jax_eval
from waveforms_tpu_torch import kernels
from waveforms_tpu_torch.ops import torch_eval, trace_cases, trace_tape

TOL_JAX = 1e-12       # of each channel's peak
TOL_JAX_F32 = 1e-6    # a float32 grid: of each channel's peak


def peak_err(got, want):
    """max over channels of max|got - want| / max|want| (complex by
    modulus)."""
    got = np.atleast_2d(np.asarray(got)).astype(np.complex128)
    want = np.atleast_2d(np.asarray(want)).astype(np.complex128)
    peak = np.maximum(np.abs(want).max(axis=-1), 1e-300)
    return float((np.abs(got - want).max(axis=-1) / peak).max())


def test_x64_active():
    assert jax.config.jax_enable_x64


CASES = list(trace_cases.CASES)


def oracle(ch, grid):
    """The numpy oracle (which takes sorted grids) on ``grid``."""
    order = np.argsort(grid, kind='stable')
    vals = np.asarray(ch(grid[order]))
    out = np.empty_like(vals)
    out[order] = vals
    return out


@pytest.mark.parametrize('name', CASES)
def test_tape_matches_xla_and_oracle(name):
    """Each channel's one-channel tape within 1e-12 of its peak of JAX's
    jitted evaluator, and of the oracle at the JAX suite's bounds."""
    chans_t, grid, (rtol, atol) = trace_cases.cases(wt)[name]
    chans_j = trace_cases.cases(wj)[name][0]
    before = kernels.trace_eval.launches
    for ch_t, ch_j in zip(chans_t, chans_j):
        got = torch_eval.evaluate(ch_t, torch.from_numpy(grid))
        assert isinstance(got, torch.Tensor) and got.device.type == 'cpu'
        got = got.numpy()
        assert got.shape == grid.shape
        if name in trace_cases.JAX_DECLINES:
            # JAX's evaluator raises; the oracle below holds the port
            with pytest.raises(TypeError):
                jax_eval.evaluate(ch_j, jnp.asarray(grid))
        else:
            ref = np.asarray(jax_eval.evaluate(ch_j, jnp.asarray(grid)))
            assert got.dtype == ref.dtype and got.shape == ref.shape
            assert peak_err(got, ref) <= TOL_JAX
        if rtol is not None:
            np.testing.assert_allclose(got, oracle(ch_t, grid), rtol=rtol,
                                       atol=atol)
    # the plain version, never the card's launch count
    assert kernels.trace_eval.launches == before


@pytest.mark.parametrize('part', ['real', 'imag', 'complex'])
@pytest.mark.parametrize('name', ['multi-channel', 'user-complex', 'exp',
                                  'vstack', 'powers', 'complex-args'])
def test_multi_channel_tape_matches_xla(name, part):
    """All of a case's channels in one tape: each row as JAX evaluates the
    channel (its real or imaginary part, or complex128; a WaveVStack
    simplified first for a non-real part, as the engines do)."""
    chans_t, grid, _ = trace_cases.cases(wt)[name]
    chans_j = trace_cases.cases(wj)[name][0]
    if part != 'real':
        chans_t = [c.simplify() if isinstance(c, wt.WaveVStack) else c
                   for c in chans_t]
        chans_j = [c.simplify() if isinstance(c, wj.WaveVStack) else c
                   for c in chans_j]
    got = torch_eval.evaluate_channels(chans_t, torch.from_numpy(grid), part)
    assert got.shape == (len(chans_t), len(grid))
    assert got.dtype == (torch.complex128 if part == 'complex'
                         else torch.float64)
    for row, ch in zip(got.numpy(), chans_j):
        ref = np.asarray(jax_eval.evaluate(ch, jnp.asarray(grid)))
        ref = (ref.astype(complex) if part == 'complex' else
               np.real(ref) if part == 'real' else np.imag(ref))
        assert peak_err(row, ref) <= TOL_JAX


@pytest.mark.parametrize('name', ['gaussian', 'cos', 'drag', 'mollifier',
                                  'multi-channel', 'vstack'])
def test_float32_grid(name):
    """A float32 grid (``sample_waveform(dtype=float32)``): float32 out,
    within the f32 bound of JAX's float32 evaluation and of the oracle."""
    chans_t, grid, _ = trace_cases.cases(wt)[name]
    chans_j = trace_cases.cases(wj)[name][0]
    g32 = grid.astype(np.float32)
    for ch_t, ch_j in zip(chans_t, chans_j):
        got = torch_eval.evaluate(ch_t, torch.from_numpy(g32))
        assert got.dtype in (torch.float32, torch.complex64)
        ref = np.asarray(jax_eval.evaluate(ch_j, jnp.asarray(g32)))
        assert got.numpy().dtype == ref.dtype
        assert peak_err(got.numpy(), ref) <= TOL_JAX_F32
        ora = np.asarray(ch_t(g32.astype(np.float64)))
        assert peak_err(got.numpy(), ora) <= 1e-5


def test_sample_waveform_float32():
    """sample_waveform's float32 grid runs the tape in float32, as JAX's
    evaluator runs the same grid."""
    def build(w):
        wav = w.gaussian(4e-9) * w.cos(2 * np.pi * 0.3e9)
        wav.start, wav.stop, wav.sample_rate = -5e-9, 5e-9, 2e10
        return wav
    got = torch_eval.sample_waveform(build(wt), dtype=np.float32,
                                     device='cpu')
    assert got.dtype == torch.float32
    t = np.arange(-5e-9, 5e-9, 1 / 2e10).astype(np.float32)
    ref = np.asarray(jax_eval.evaluate(build(wj), jnp.asarray(t)))
    assert peak_err(got.numpy(), ref) <= TOL_JAX_F32


def test_tape_is_cached_and_uploaded_once():
    """Structurally equal channels share one tape (built and uploaded
    once); another structure is another tape."""
    a = [wt.gaussian(4) * wt.cos(5.0), wt.square(2) >> 1]
    b = [wt.gaussian(4) * wt.cos(5.0), wt.square(2) >> 1]
    key = lambda chans: tuple(trace_tape.channel_key(c) for c in chans)  # noqa: E731
    ta, tb = trace_tape.tape_of(key(a)), trace_tape.tape_of(key(b))
    assert ta is tb
    assert ta.tensors('cpu')[0] is tb.tensors('cpu')[0]
    assert trace_tape.tape_of(key(a[:1])) is not ta
    f1 = torch_eval.compile_waveform(a[0].bounds, a[0].seq, a[0].min,
                                     a[0].max)
    f2 = torch_eval.compile_waveform(b[0].bounds, b[0].seq, b[0].min,
                                     b[0].max)
    assert f1 is f2


def test_tape_layout():
    """The records a tape holds: channels, waveforms (shared where equal),
    segments with ZERO ones kept as no work, terms, factors deduplicated,
    the user basis as an external slot."""
    chans = [wt.cosPulse(2.0) >> 1, wt.cosPulse(2.0) >> 1,
             wt.function(trace_cases.user_real, 2.0) * wt.gaussian(3)]
    tape = trace_tape.tape_of(tuple(trace_tape.channel_key(c)
                                    for c in chans))
    P = tape.prog.tolist()
    n_ch, o_ch, o_wv, o_sg, o_tm, o_tf, o_uf, n_ext = P[:8]
    assert n_ch == 3 and n_ext == 1 and len(tape.ext) == 1
    assert tape.complex == (False, False, False)
    # the two equal channels point at one waveform record
    assert P[o_ch] == P[o_ch + trace_tape.R_CH]
    n_seg = (o_tm - o_sg) // trace_tape.R_SG
    nterm = P[o_sg + 1:o_tm:trace_tape.R_SG]
    assert n_seg == len(chans[0].seq) + len(chans[2].seq)
    assert nterm.count(0) == sum(s == ((), ()) for c in (chans[0], chans[2])
                                 for s in c.seq)
    codes = P[o_uf::trace_tape.R_UF]
    assert codes.count(0) == 1      # one external slot
    assert tape.real                # T1's real build
    cx = trace_tape.tape_of((trace_tape.channel_key((1 + 1j) * chans[0]),))
    assert not cx.real


@pytest.mark.parametrize('name', CASES)
def test_real_flag_agrees_with_the_plain_version(name, monkeypatch):
    """``Tape.real`` (T1's real build) holds exactly where the plain
    version computes no complex value, for a case's multi-channel tape and
    each channel's own."""
    from waveforms_tpu_torch.ops import reference_trace
    seen = []
    expr = reference_trace._Reader.expr

    def spy(self, *args):
        acc = expr(self, *args)
        seen.append(acc.is_complex())
        return acc
    monkeypatch.setattr(reference_trace._Reader, 'expr', spy)
    chans, grid, _ = trace_cases.cases(wt)[name]
    g = torch.from_numpy(grid)
    for group in [chans] + [[c] for c in chans]:
        tape = trace_tape.tape_of(tuple(trace_tape.channel_key(c)
                                        for c in group))
        seen.clear()
        trace_tape.run(tape, g, 'complex')
        assert tape.real == (not any(seen))


def test_plain_version_flagged_real_raises_on_a_complex_value():
    tape = trace_tape.tape_of((trace_tape.channel_key(
        (1 + 1j) * wt.gaussian(4)),))
    prog, pool = tape.tensors('cpu')
    g = torch.linspace(-1, 1, 11, dtype=torch.float64)
    out = torch.empty((1, 11), dtype=torch.complex128)
    with pytest.raises(ValueError, match='flagged real'):
        kernels.trace_eval(prog, pool, g, None, None, out, 2, True)


def test_nan_and_infinite_samples_match_xla():
    """A NaN sample lies outside every segment (0) unless the waveform is
    one unbounded segment, which evaluates it (NaN), in the plain version
    and in JAX's evaluator alike; -inf lies in the first segment, and +inf
    in a one-segment waveform evaluates it.  (T1 is held to the plain
    version on the same samples on the card.)"""
    def build(w):
        return [w.cos(3.0) + w.square(2), w.cos(3.0), w.gaussian(2) >> 0.5,
                w.WaveVStack([w.cos(3.0) + w.square(2), w.gaussian(1)])
                >> 0.1]
    grid = np.array([np.nan, 0.5, -np.inf, -3.0, 1.0, np.nan, 2.5])
    got = torch_eval.evaluate_channels(build(wt), torch.from_numpy(grid))
    got = got.numpy()
    for row, ch in zip(got, build(wj)):
        ref = np.asarray(jax_eval.evaluate(ch, jnp.asarray(grid)))
        np.testing.assert_array_equal(np.isnan(row), np.isnan(ref))
        ok = ~np.isnan(ref)
        assert peak_err(row[ok], ref[ok]) <= TOL_JAX
    assert got[0, 0] == 0 and got[0, 5] == 0     # the NaN samples
    assert np.isnan(got[1, 0]) and np.isnan(got[1, 2])
    whole = torch_eval.evaluate(wt.cos(3.0), torch.tensor([np.inf]))
    ref = jax_eval.evaluate(wj.cos(3.0), jnp.asarray([np.inf]))
    assert np.isnan(whole.numpy()).all() and np.isnan(np.asarray(ref)).all()


def test_operations_count_follows_the_data():
    """chip_smoke.py's operation count for T1's bound covers each sample's
    search and the live segments' work, and grows with the samples inside
    the pulse."""
    import chip_smoke
    wav = wt.gaussian(1.0) >> 5
    tape = trace_tape.tape_of((trace_tape.channel_key(wav),))
    far = chip_smoke.trace_operations(tape, np.linspace(-100, -50, 1000))
    near = chip_smoke.trace_operations(tape, np.linspace(4.5, 5.5, 1000))
    assert 0 < far < near


def test_builtins_with_complex_arguments_stay_off_the_host(monkeypatch):
    """A built-in with a complex argument never takes the host callback:
    exp, cos, cosh, sinh, sinc, gaussian and interp's points are T1's own
    complex records, a chirp with a complex phase an external slot filled
    by its lowering on the grid's device."""
    from waveforms_tpu_torch.ops import torch_basis

    def host(fun_id):
        raise AssertionError(f"basis {fun_id} went to the host")
    monkeypatch.setattr(torch_basis, '_host_lowering', host)
    chans, grid, _ = trace_cases.cases(wt)['complex-args']
    trace_tape.tape_of.cache_clear()
    tape = trace_tape.tape_of(tuple(trace_tape.channel_key(c)
                                    for c in chans))
    r = trace_tape.Records(tape.prog, tape.pool)
    recs = [r.rec('uf', i)
            for i in range((len(r.P) - r.off['uf']) // trace_tape.R_UF)]
    cx = sorted({code for code, _, _, c in recs if code and c})
    assert cx == sorted(torch_basis.COMPLEX_ARGS - {7})
    assert [e[0] for e in tape.ext] == [8]      # the chirp
    out = trace_tape.run(tape, torch.from_numpy(grid), 'complex')
    assert out.dtype == torch.complex128 and out.shape == (len(chans),
                                                           len(grid))
    interp = trace_cases.cases(wt)['interp-complex'][0]
    tape = trace_tape.tape_of(tuple(trace_tape.channel_key(c)
                                    for c in interp))
    assert not tape.ext and all(tape.complex)


def test_compile_expr_runs_a_tape():
    expr = (wt.gaussian(4) * wt.cos(5.0)).seq[1]
    t = np.linspace(-1, 1, 101)
    got = torch_eval.compile_expr(expr)(torch.from_numpy(t))
    ref = np.asarray(jax_eval.compile_expr(
        (wj.gaussian(4) * wj.cos(5.0)).seq[1])(jnp.asarray(t)))
    assert peak_err(got.numpy(), ref) <= TOL_JAX


def test_grid_shapes_and_integer_grid():
    """A 2-D grid keeps its shape; an integer grid runs in float64."""
    wav = wt.gaussian(4) >> 1
    t = np.linspace(-3, 3, 60).reshape(6, 10)
    got = torch_eval.evaluate(wav, torch.from_numpy(t))
    assert got.shape == (6, 10)
    np.testing.assert_allclose(got.numpy(), wav(t.ravel()).reshape(6, 10),
                               rtol=1e-9, atol=1e-12)
    ints = torch_eval.evaluate(wav, np.arange(-3, 4))
    assert ints.dtype == torch.float64
    np.testing.assert_allclose(ints.numpy(), wav(np.arange(-3.0, 4.0)),
                               rtol=1e-9, atol=1e-12)


def test_complex_clip_raises_as_torch_clamp():
    wav = (1 + 1j) * wt.gaussian(4)
    wav.max = 0.5
    with pytest.raises(RuntimeError, match='complex'):
        torch_eval.evaluate(wav, torch.linspace(-1, 1, 11,
                                                dtype=torch.float64))
