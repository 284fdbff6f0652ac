"""The dense kernel's window, streaming synthesis, ``engine.sample`` and the
shot pipeline on the CPU, against the JAX package.

The port runs on ``device='cpu'``, where K1 is its plain version
(``ops.reference.dense_walk``) and the IIR recurrence kernel its plain
version too.  The JAX side runs as its suite runs it: K1 through
``_run_kernel(row0, ...)`` in interpret mode, x64 on.

Tolerances: f32 samples within 1e-6 of each channel's peak of JAX's
(both accumulate in f32 with the same formulas; transcendental
implementations and rounding order differ), int16 codes within one code,
and the port's stream equal to its own one-shot K1 output bit for bit.
Filtered streams are held to JAX's within 1e-9 of the peak (both filter
in f64; the inputs differ by the f32 contract only where the kernels'
rounding differs, which the filter passes on at its gain), and to scipy
at the JAX tests' bounds.  ``engine.sample`` filters in the signal's f32,
as JAX does: there the two agree within 1e-5 of the peak (each is 7e-5 off
scipy's f64 filter).  The pipeline's IQ points within 1e-5 of their peak
(K1's f32 contract through the f32 products).
"""

import numpy as np
import pytest
import torch
from scipy.signal import butter, sosfilt as sp_sosfilt, tf2sos

import jax.numpy as jnp
import waveforms_tpu as wj
from waveforms_tpu.core import WaveVStack as WaveVStackJ
from waveforms_tpu.distortion import exp_decay_filter
from waveforms_tpu.ops.lowering import lower_schedule as lower_j
from waveforms_tpu.ops.pallas_synth import DeviceSchedule as DeviceJ
from waveforms_tpu.ops.pallas_synth import _run_kernel, validate_out_mode
from waveforms_tpu.ops.sequencer import Sequencer as SequencerJ
from waveforms_tpu.ops.streaming import synthesize_stream as stream_j
from waveforms_tpu.parallel.pipeline import run_sequence as run_sequence_j
import waveforms_tpu_torch as wt
from waveforms_tpu_torch import kernels
from waveforms_tpu_torch.convert import lowered_from_jax
from waveforms_tpu_torch.ops import Sequencer
from waveforms_tpu_torch.ops.streaming import synthesize_stream
from waveforms_tpu_torch.ops.synth import DeviceSchedule, synthesize_device
from waveforms_tpu_torch.parallel import run_sequence

TOL = 1e-6


def rel(a, b):
    """Max over channels of max|a - b| / max|b| (complex by modulus)."""
    a = np.asarray(a)
    b = np.asarray(b)
    dt = np.complex128 if np.iscomplexobj(a) or np.iscomplexobj(b) \
        else np.float64
    a, b = a.astype(dt), b.astype(dt)
    peak = np.maximum(np.abs(b).max(axis=-1), 1e-30)
    return float((np.abs(a - b).max(axis=-1) / peak).max())


def codes(a, b):
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b)).max())


def port_dev(low_j):
    return DeviceSchedule(lowered_from_jax(low_j), 'cpu')


def _pulses(mod, n_ch=4, spacing=300e-9):
    return [0.5 * mod.cosPulse(50e-9) >> (k * spacing + 0.1e-6)
            for k in range(n_ch)]


def _window_schedule(mod):
    """4 channels of pulses and a chirp-like carrier over 8000 samples (not
    a whole number of 128-sample rows)."""
    chans = [(0.5 * mod.cosPulse(300e-9) >> (0.4e-6 + 0.9e-6 * k))
             * mod.cos(2 * np.pi * (90e6 + 7e6 * k)) for k in range(3)]
    chans.append(0.3 * (mod.square(1.2e-6, edge=0.1e-6) >> 3.1e-6))
    return chans


# (row0, n_rows), n_rows whole JAX tiles of 8 rows: offsets on and off the
# start, the last window ending at
# the schedule's 8000 samples rounded up to whole rows (8064)
WINDOWS = [(0, 56), (1024, 8), (2048, 40), (3072, 16), (7040, 8)]


@pytest.mark.parametrize('row0,n_rows', WINDOWS)
@pytest.mark.parametrize('mode', ['f32', 'int16', 'pair'])
def test_dense_window_matches_jax_run_kernel(row0, n_rows, mode):
    low = lower_j(_window_schedule(wj), 0, 4e-6, 2e9,
                  part='complex' if mode == 'pair' else 'real')
    assert low.n_samples == 8000 and low.shape[1] == 1
    dj = DeviceJ(low)
    C, NB, S, T, F = dj.shape
    out_dtype = jnp.int16 if mode == 'int16' else jnp.float32
    scale = validate_out_mode(out_dtype, dj.amp_im, C, 1000.0)
    ref = _run_kernel(jnp.full((1, 1, 1, 1), row0, jnp.int32), *dj.tensors,
                      dj.amp_im, None if scale is None else jnp.asarray(scale),
                      S=S, T=T, F=F, R=8, n_rows=n_rows, tiles_per_bucket=1,
                      ops_present=dj.ops_present, interpret=True,
                      out_dtype=out_dtype)
    if mode == 'pair':
        ref = (np.asarray(ref[0]) + 1j * np.asarray(ref[1])).reshape(C, -1)
    else:
        ref = np.asarray(ref).reshape(C, -1)
    dev = port_dev(low)
    n_out = n_rows * 128
    dtype = {'f32': torch.float32, 'int16': torch.int16,
             'pair': torch.complex64}[mode]
    sc = torch.full((C,), 1000.0) if mode == 'int16' else None
    windowed = kernels.synth_dense.windowed_launches
    got = kernels.synth_dense(dev, torch.empty(C, n_out, dtype=dtype), sc,
                              row0, n_out).numpy()
    assert kernels.synth_dense.windowed_launches == windowed  # plain version
    if mode == 'int16':
        assert codes(got, ref) <= 1
    else:
        assert rel(got, ref) <= TOL
    # the window is a slice of the whole schedule's output, bit for bit
    whole = synthesize_device(dev, out_dtype=None if mode != 'int16'
                              else torch.int16, dac_scale=1000.0).numpy()
    stop = min(row0 + n_out, low.n_samples)
    np.testing.assert_array_equal(got[:, :stop - row0], whole[:, row0:stop])


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
def test_dense_window_narrowed_stores(dtype):
    """bf16/f16 windows are the f32 window rounded once."""
    dev = port_dev(lower_j(_window_schedule(wj), 0, 4e-6, 2e9))
    f32 = kernels.synth_dense(dev, torch.empty(4, 2048), None, 2048, 2048)
    got = kernels.synth_dense(dev, torch.empty(4, 2048, dtype=dtype), None,
                              2048, 2048)
    assert torch.equal(got, f32.to(dtype))


@pytest.mark.parametrize('row0,n_out,match', [
    (100, 128, 'multiple of 128'), (-128, 128, 'multiple of 128'),
    (7936, 256, 'outside'), (0, 8065, 'outside'), (0, -1, 'outside')])
def test_dense_window_refusals(row0, n_out, match):
    """A bad window raises; it is never clamped."""
    dev = port_dev(lower_j(_window_schedule(wj), 0, 4e-6, 2e9))
    with pytest.raises(ValueError, match=match):
        kernels.synth_dense(dev, torch.empty(4, max(n_out, 0)), None, row0,
                            n_out)


def _concat(chunks):
    return np.concatenate([np.asarray(c) for c in chunks], axis=1)


def _stream_case(name):
    """(JAX lowering, stream kwargs) of tests/test_streaming.py's cases."""
    rng = np.random.default_rng(1)
    if name == 'oneshot':
        return lower_j(_pulses(wj), 0, 1.31072e-6, 2e9), {
            'chunk_rows': 8, 'rows_per_tile': 8}
    if name == 'bucketed':
        stack = WaveVStackJ([(0.3 * wj.cosPulse(40e-9) >> o)
                             for o in rng.uniform(0, 7e-6, 100)])
        return lower_j([stack], 0, 8.192e-6, 2e9, bucket_samples=2048), {
            'chunk_rows': 32, 'rows_per_tile': 16}
    I, Q = wj.mixing(0.5 * wj.cosPulse(50e-9), freq=-80e6,
                     DRAGScaling=1e-10)
    if name == 'pair':
        stack = WaveVStackJ([((I + 1j * Q) >> o)
                             for o in np.random.default_rng(2).uniform(
                                 0, 7e-6, 30)])
        return lower_j([stack], 0, 8.192e-6, 2e9, part='complex',
                       bucket_samples=2048), {'chunk_rows': 32,
                                              'rows_per_tile': 8}
    if name == 'pair_two_channels':
        I, Q = wj.mixing(0.5 * wj.cosPulse(50e-9), freq=-60e6,
                         DRAGScaling=1e-10)
        return lower_j([(I + 1j * Q) >> 0.2e-6, (I + 1j * Q) >> 1.1e-6], 0,
                       2.097152e-6, 2e9, part='complex'), {
            'chunk_rows': 8, 'rows_per_tile': 8}
    raise KeyError(name)


@pytest.mark.parametrize('name', ['oneshot', 'bucketed', 'pair',
                                  'pair_two_channels'])
def test_stream_equals_oneshot_and_jax(name):
    low, kw = _stream_case(name)
    dev = port_dev(low)
    got = _concat(synthesize_stream(dev, **kw))
    whole = synthesize_device(dev).numpy()
    assert got.shape == whole.shape and got.dtype == whole.dtype
    np.testing.assert_array_equal(got, whole)
    want = _concat(stream_j(DeviceJ(low), interpret=True, **kw))
    assert want.dtype == got.dtype
    assert rel(got, want) <= TOL


@pytest.mark.parametrize('name,initial', [('oneshot', 0.0), ('bucketed', 0.0),
                                          ('pair', 0.0), ('pair', 0.25),
                                          ('pair_two_channels', 0.0)])
def test_stream_with_filters_matches_jax_and_scipy(name, initial):
    """Carried SOS state across chunks: the planes of a pair-mode schedule
    as one batched call, the DC ``initial`` on the real plane only."""
    low, kw = _stream_case(name)
    sos = tf2sos(*butter(3, 0.05))
    dev = port_dev(low)
    got = _concat(synthesize_stream(dev, filters=(sos, initial), **kw))
    want = _concat(stream_j(DeviceJ(low), filters=(sos, initial),
                            interpret=True, **kw))
    assert got.dtype == want.dtype
    assert rel(got, want) <= 1e-9 * 1e3      # the f32 contract x filter gain
    whole = synthesize_device(dev).numpy()
    for c in range(whole.shape[0]):
        re = whole[c].real.astype(float)
        ref = sp_sosfilt(sos, re - initial) + initial
        if np.iscomplexobj(whole):
            ref = ref + 1j * sp_sosfilt(sos, whole[c].imag.astype(float))
        assert rel(got[c], ref) <= 1e-12


def test_stream_filters_match_host_waveform_sample():
    """tests/test_streaming.py's host check: chunked device filtering
    carries zi exactly like Waveform.sample()."""
    sos = tf2sos(*butter(3, 0.02))
    wav = (wt.step(0) >> 50e-9) * wt.cos(2 * np.pi * 20e6)
    wav.start, wav.stop, wav.sample_rate = 0, 1.048576e-6, 2e9
    wav.filters = (sos, 0.0)
    host = wav.sample()
    low = wt.ops.lowering.lower_schedule([wav], 0, wav.stop, 2e9)
    dev = DeviceSchedule(low, 'cpu')
    got = _concat(synthesize_stream(dev, chunk_rows=4, rows_per_tile=4,
                                    filters=(sos, 0.0)))[0]
    np.testing.assert_allclose(got, host, atol=2e-7)


def test_stream_int16_codes_and_refusals():
    w = [wj.gaussian(100e-9) >> 0.3e-6, 0.5 * wj.cosPulse(80e-9) >> 0.7e-6]
    low = lower_j(w, 0, 1e-6, 2e9)
    dev = port_dev(low)
    got = _concat(synthesize_stream(dev, chunk_rows=8, rows_per_tile=8,
                                    out_dtype=torch.int16, dac_scale=1000.0))
    assert got.dtype == np.int16
    whole = synthesize_device(dev, out_dtype=torch.int16,
                              dac_scale=1000.0).numpy()
    np.testing.assert_array_equal(got, whole)
    want = _concat(stream_j(DeviceJ(low), chunk_rows=8, rows_per_tile=8,
                            interpret=True, out_dtype=jnp.int16,
                            dac_scale=1000.0))
    assert codes(got, want) <= 1
    sos = tf2sos(*butter(3, 0.1))
    for dt in (torch.int16, torch.bfloat16, torch.float16):
        with pytest.raises(ValueError, match='quantized streaming'):
            next(synthesize_stream(dev, chunk_rows=8, rows_per_tile=8,
                                   out_dtype=dt, filters=(sos, 0)))
    with pytest.raises(ValueError, match='multiple of 16'):
        next(synthesize_stream(dev, chunk_rows=8, rows_per_tile=16))
    bucketed, _ = _stream_case('bucketed')
    bdev = port_dev(bucketed)
    with pytest.raises(ValueError, match='whole buckets'):
        next(synthesize_stream(bdev, chunk_rows=8, rows_per_tile=8))
    with pytest.raises(ValueError, match='multiple of the tile'):
        next(synthesize_stream(bdev, chunk_rows=64, rows_per_tile=32))


def test_stream_default_tile_divides_the_chunk():
    """rows_per_tile=None takes JAX's tile (``divides``) and streams the
    schedule unchanged."""
    low, _ = _stream_case('bucketed')
    dev = port_dev(low)
    got = _concat(synthesize_stream(dev, chunk_rows=48))
    np.testing.assert_array_equal(got, synthesize_device(dev).numpy())
    want = _concat(stream_j(DeviceJ(low), chunk_rows=48, interpret=True))
    assert rel(got, want) <= TOL


def _filtered_wav(mod, filters):
    wav = (mod.step(0) >> 50e-9) * mod.cos(2 * np.pi * 20e6) + 0.1
    wav.start, wav.stop, wav.sample_rate = 0, 1.048576e-6, 2e9
    wav.filters = filters
    return wav


@pytest.mark.parametrize('initial', [None, 0.0, 0.2],
                         ids=['no_filters', 'filters', 'filters_initial'])
@pytest.mark.parametrize('engine', ['auto', 'numpy'])
def test_engine_sample_matches_jax(engine, initial):
    sos = tf2sos(*butter(3, 0.02))
    filters = None if initial is None else (sos, initial)
    got = wt.sample(_filtered_wav(wt, filters), engine=engine, device='cpu')
    want = wj.sample(_filtered_wav(wj, filters),
                     engine='pallas' if engine == 'auto' else 'numpy')
    if engine == 'numpy':
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, np.asarray(want))
        return
    assert got.device.type == 'cpu'
    got = got.numpy()
    assert got.dtype == np.asarray(want).dtype == np.float32
    # both filter in f32, each 7e-5 of the peak off scipy's f64 filter of
    # the oracle; the two agree to 3.3e-6
    assert rel(got, want) <= (TOL if initial is None else 1e-5)


def _station_tables():
    """3 schedules of 2 channels: an XY pulse train and a Z square."""
    rng = np.random.default_rng(3)

    def chans(mod):
        out = []
        for k in range(3):
            xy = mod.zero()
            for g in range(3):
                I, _ = mod.mixing(0.5 * mod.cosPulse(30e-9)
                                  >> (0.2e-6 + g * 0.6e-6 + 0.05e-6 * k),
                                  freq=-150e6, phase=0.7 * k,
                                  DRAGScaling=1e-10)
                xy += I
            out.append([xy, 0.3 * (mod.square(80e-9, edge=10e-9)
                                   >> (0.5e-6 + 0.8e-6 * k))])
        return out
    lows = [lower_j(c, 0, 2.048e-6, 2e9) for c in chans(wj)]
    order = rng.integers(0, 3, 7)
    order[-1] = 9                      # clamped to the last schedule
    return lows, order


@pytest.mark.parametrize('demod', [False, True], ids=['signals', 'iq'])
def test_run_sequence_matches_jax(demod):
    lows, order = _station_tables()
    freqs = [-121.64e6, -67.52e6] if demod else None
    got = run_sequence(Sequencer([lowered_from_jax(l) for l in lows],
                                 device='cpu'), order, demod_freqs=freqs)
    want = np.asarray(run_sequence_j(SequencerJ(lows), order,
                                     demod_freqs=freqs, interpret=True))
    assert tuple(got.shape) == want.shape
    assert got.shape[:2] == (len(order), 2)
    got = got.numpy()
    assert got.dtype == want.dtype
    if demod:
        assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5
    else:
        assert max(rel(g, w) for g, w in zip(got, want)) <= TOL


@pytest.mark.parametrize('demod', [False, True], ids=['signals', 'iq'])
def test_run_sequence_filtered_matches_jax_functions_in_f64(demod):
    """With the Z-settle pre-compensation the port filters in float64:
    held against JAX's own play, lfilter (in f64) and demodulate on the
    same shots, and against scipy.  JAX's run_sequence filters the f32
    signal instead, 0.11 of the peak off scipy on these shots: the port is
    held to be at least 100 times closer (see parallel/pipeline.py)."""
    from scipy.signal import lfilter as sp_lfilter, lfiltic

    from waveforms_tpu.distortion import combine_filters
    from waveforms_tpu.ops.demod import demod_matrix, demodulate
    from waveforms_tpu.ops.iir import lfilter as lfilter_j
    from waveforms_tpu.utils.signal import getFTMatrix

    lows, order = _station_tables()
    ba = [exp_decay_filter(a, t, 2e9, inv=True)
          for a, t in zip([0.02, 0.005], [3e-6, 20e-6])]
    freqs = [-121.64e6, -67.52e6] if demod else None
    got = run_sequence(Sequencer([lowered_from_jax(l) for l in lows],
                                 device='cpu'), order, ba_filters=ba,
                       demod_freqs=freqs).numpy()
    seq_j = SequencerJ(lows)
    jax_f32 = None if demod else np.asarray(
        run_sequence_j(seq_j, order, ba_filters=ba, interpret=True))
    b, a = combine_filters(ba)
    zi = lfiltic(b, a, np.zeros(len(a) - 1), np.zeros(len(b) - 1))
    n = lows[0].n_samples
    for i, k in enumerate(order):
        sig = np.asarray(seq_j.play(int(k), interpret=True)).astype(float)
        filt = np.stack([np.asarray(lfilter_j(b, a, jnp.asarray(r),
                                              zi=jnp.asarray(zi))[0])
                         for r in sig])
        host = np.stack([sp_lfilter(b, a, r, zi=zi)[0] for r in sig])
        if demod:
            want = np.asarray(demodulate(jnp.asarray(filt),
                                         demod_matrix(freqs, n, 2e9)))
            ref = host @ getFTMatrix(freqs, n, sampleRate=2e9)
            assert np.abs(got[i] - want).max() / np.abs(want).max() <= 1e-5
            assert np.abs(got[i] - ref).max() / np.abs(ref).max() <= 1e-4
        else:
            assert got.dtype == np.float64
            assert rel(got[i], filt) <= TOL
            assert rel(got[i], host) <= TOL
            assert rel(jax_f32[i], host) >= 100 * rel(got[i], host)
