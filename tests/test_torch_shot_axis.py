"""The sequencer's shot index on the device: the port against JAX.

The port's ``Sequencer.play_many`` / ``play`` / ``play_sparse`` take the
shot index as an int, a list, an array or a tensor and play a whole shot
vector in one launch of K1's or K7's shot entry, which reads and clamps
each shot's index on the device (``kernels.synth_dense.shots``,
``kernels.synth_sparse.shots``); ``parallel.run_sequence`` runs on the card
as one CUDA graph a shot.  On the CPU the shot entries run their plain
versions (``reference.dense_walk_shots``, ``reference.sparse_walk_shots``)
and ``run_sequence`` the host loop, which the card's graph is held to
(``tests/test_torch_cuda.py``).  Here the same seeded schedules, lowered by
the JAX package and carried over with ``convert.lowered_from_jax``, go
through JAX's ``Sequencer`` (``vmap`` over the index, Pallas in interpret
mode) and through the port's on the CPU, with indices past both ends of the
table.

Tolerances and why:

* f32 and complex64 (pair mode, by modulus): within 1e-6 of each
  channel's peak of the JAX result (both f32, same formulas, different
  summation and transcendental code), as ``tests/test_torch_sequencer.py``;
* int16 codes: within one code of JAX's (the f32 sums they quantize may
  differ in the last bit);
* bf16 and f16: equal to the port's own f32 output rounded once to nearest
  even, which is what the kernels store;
* the plain shot versions against the one-shot plain versions, and the
  closures of the pipeline's filter against ``lfilter``: bit for bit (the
  same arithmetic);
* ``run_sequence`` against JAX's: the bounds of
  ``tests/test_torch_streaming.py`` (IQ points within 1e-5 of the peak,
  signals within 1e-6 of each channel's peak).
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import waveforms_tpu as wj
from waveforms_tpu.ops.lowering import lower_schedule as lower_j
from waveforms_tpu.ops.sequencer import Sequencer as SeqJ
from waveforms_tpu.parallel.pipeline import run_sequence as run_sequence_j
from waveforms_tpu_torch import kernels
from waveforms_tpu_torch.convert import lowered_from_jax
from waveforms_tpu_torch.ops import Sequencer
from waveforms_tpu_torch.ops.iir import lfilter
from waveforms_tpu_torch.parallel import run_sequence, run_sequence_loop
from waveforms_tpu_torch.parallel.pipeline import _make_postfilter
from test_torch_pair import rel
from test_torch_streaming import TOL, _station_tables

FS = 2e9
STOP = 4.096e-6                    # 8,192 samples
TOL_JAX = 1e-6
#: a shot vector with indices past both ends of the 4-schedule table
KS = [2, -3, 99, 0, 1]


def _channels(seed):
    """Three channels of one schedule: a DRAG'd carrier pulse train, a
    gaussian on a 150 MHz carrier, a flat-top square."""
    r = np.random.default_rng(seed)
    xy = wj.zero()
    for t0 in np.sort(r.uniform(0.2e-6, 3.8e-6, 3)):
        xy += (0.4 * wj.cosPulse(40e-9)
               * wj.cos(2 * np.pi * 120e6, float(r.uniform()))) >> float(t0)
    ro = 0.3 * wj.gaussian(80e-9) * wj.cos(2 * np.pi * 150e6) >> float(
        r.uniform(1e-6, 3e-6))
    z = 0.2 * wj.square(300e-9, edge=20e-9) >> float(r.uniform(0.5e-6, 3e-6))
    return [xy, ro, z]


@lru_cache(maxsize=None)
def tables(part):
    """(JAX Sequencer, port Sequencer on the CPU) of 4 seeded schedules of
    3 channels x 8,192 samples, one bucket."""
    lows = [lower_j(_channels(s), 0.0, STOP, FS, part=part,
                    bucket_samples=None) for s in range(4)]
    return SeqJ(lows), Sequencer([lowered_from_jax(l) for l in lows],
                                 device='cpu')


@lru_cache(maxsize=None)
def jax_play_many(part, mode):
    """JAX's vmapped play_many of KS (interpret mode), one mode each."""
    sj, _ = tables(part)
    kw = {'rows_per_tile': 8, 'interpret': True}
    if mode == 'sparse':
        kw.update(sparse=True, Rs=8)
    elif mode == 'int16':
        kw.update(out_dtype=jnp.int16, dac_scale=30000.0)
    return np.asarray(sj.play_many(np.array(KS, np.int32), **kw))


MODES = ['float32', 'int16', 'bfloat16', 'float16', 'complex64', 'sparse']


@pytest.mark.parametrize('mode', MODES)
def test_play_many_with_a_tensor_index_matches_jax(mode):
    """One shot vector as a CPU tensor, with indices past both ends,
    against JAX's play_many (one vmapped launch) of the same vector."""
    part = 'complex' if mode == 'complex64' else 'real'
    _, st = tables(part)
    ks = torch.tensor(KS)
    n = kernels.synth_dense.launches + kernels.synth_sparse.launches
    if mode == 'sparse':
        got = st.play_many(ks, sparse=True, Rs=8)
    elif mode in ('float32', 'complex64'):
        got = st.play_many(ks)
    elif mode == 'int16':
        got = st.play_many(ks, out_dtype=torch.int16, dac_scale=30000.0)
    else:
        got = st.play_many(ks, out_dtype=getattr(torch, mode))
    assert kernels.synth_dense.launches + kernels.synth_sparse.launches == n
    assert tuple(got.shape) == (len(KS), 3, st.n_samples)
    if mode in ('bfloat16', 'float16'):
        assert got.dtype == getattr(torch, mode)
        assert torch.equal(got, st.play_many(ks).to(got.dtype))
        return
    ref = jax_play_many(part, 'float32' if mode == 'complex64' else mode)
    got = got.numpy()
    if mode == 'int16':
        assert got.dtype == np.int16
        assert np.abs(got.astype(int) - ref).max() <= 1
        return
    assert got.dtype == (np.complex64 if part == 'complex' else np.float32)
    assert rel(got, ref) <= TOL_JAX


@pytest.mark.parametrize('method', ['play', 'play_sparse'])
def test_play_with_a_0d_tensor_matches_jax_traced_index(method):
    """``play(torch.tensor(k))`` against JAX's ``play(jnp.int32(k))``, the
    traced-index form, at both ends and past them."""
    sj, st = tables('real')
    kw = {'Rs': 8} if method == 'play_sparse' else {}
    for k in (-1, 1, 3, 7):
        got = getattr(st, method)(torch.tensor(k), **kw)
        ref = getattr(sj, method)(jnp.int32(k), interpret=True,
                                  **(kw or {'rows_per_tile': 8}))
        assert tuple(got.shape) == (3, st.n_samples)
        assert rel(got.numpy(), np.asarray(ref)) <= TOL_JAX
        assert torch.equal(got, getattr(st, method)(min(max(k, 0), 3), **kw))


@pytest.mark.parametrize('mode', ['float32', 'int16', 'bfloat16',
                                  'complex64', 'sparse'])
def test_plain_shot_versions_equal_the_one_shot_plain_versions(mode):
    """``synth_dense.plain_shots`` / ``synth_sparse.plain_shots`` (what
    the shot entries compute) against the one-shot plain versions on each
    shot's clamped schedule, bit for bit."""
    _, st = tables('complex' if mode == 'complex64' else 'real')
    ks = torch.tensor(KS, dtype=torch.int32)
    C, N = st.shape[0], st.n_samples
    dt = {'int16': torch.int16, 'bfloat16': torch.bfloat16,
          'complex64': torch.complex64}.get(mode, torch.float32)
    scale = torch.full((C,), 30000.0) if mode == 'int16' else None
    if mode == 'sparse':
        got = kernels.synth_sparse.plain_shots(
            st, st._stacked_work(8), ks, torch.zeros((len(KS), C, N)), None)
    else:
        got = kernels.synth_dense.plain_shots(
            st, ks, torch.empty((len(KS), C, N), dtype=dt), scale)
    for s, k in enumerate(KS):
        k = st._clamp(k)
        if mode == 'sparse':
            one = kernels.synth_sparse.plain(*st._sparse_args(k, 8),
                                             torch.zeros((C, N)), None)
        else:
            one = kernels.synth_dense.plain(
                st._schedule(k), torch.empty((C, N), dtype=dt), scale)
        assert torch.equal(got[s], one), (s, k)


def test_shot_indices_clamp_and_refuse_the_wrong_rank():
    """Indices become one int32 vector on the table's device, clamped to
    the table; ``play`` takes one index, ``play_many`` a vector."""
    _, st = tables('real')
    for ks in (KS, np.array(KS), torch.tensor(KS),
               torch.tensor(KS, dtype=torch.int16)):
        got = st.shot_indices(ks)
        assert got.dtype == torch.int32
        assert got.tolist() == [2, 0, 3, 0, 1]
    assert st.shot_indices(torch.tensor(-5), 0).tolist() == [0]
    assert st.shot_indices(np.int64(9), 0).tolist() == [3]
    assert tuple(st.play_many([]).shape) == (0, 3, st.n_samples)
    with pytest.raises(ValueError, match='0-D'):
        st.play(torch.tensor([1]))
    with pytest.raises(ValueError, match='1-D'):
        st.play_many(torch.tensor([[0, 1]]))
    with pytest.raises(ValueError, match='1-D'):
        st.play_many(1, sparse=True)


@pytest.mark.parametrize('filt', ['z_settle', 'butter'])
def test_the_pipeline_filter_closure_equals_lfilter(filt):
    """``run_sequence``'s filter closure (constants on the device once, so
    a graph can capture it) against ``lfilter`` with the same ``zi`` in
    float64, bit for bit, on the S1 route (the Z-settle pair, clustered
    near-unit poles) and the doubling scan (a Butterworth low-pass)."""
    from scipy.signal import butter, lfiltic

    from waveforms_tpu_torch.distortion import combine_filters
    if filt == 'z_settle':
        from waveforms_tpu_torch.distortion import exp_decay_filter
        ba = [exp_decay_filter(x, t, FS, inv=True)
              for x, t in ((0.02, 3e-6), (0.005, 20e-6))]
    else:
        ba = [butter(3, 0.05)]
    b, a = combine_filters(ba)
    zi = lfiltic(b, a, np.zeros(len(a) - 1), np.zeros(len(b) - 1))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 4096)))
    want = lfilter(b, a, x, zi=torch.as_tensor(zi))[0]
    assert torch.equal(_make_postfilter(ba, 'cpu', 4096)(x), want)


@pytest.mark.parametrize('demod', [False, True], ids=['signals', 'iq'])
def test_run_sequence_with_a_tensor_index_matches_jax(demod):
    """``run_sequence`` with the shot order as a tensor (one index past the
    table) against JAX's ``jit(lax.scan)``, and bit-equal to the host loop
    given the order as a list."""
    lows, order = _station_tables()
    freqs = [-121.64e6, -67.52e6] if demod else None
    seq = Sequencer([lowered_from_jax(l) for l in lows], device='cpu')
    got = run_sequence(seq, torch.tensor(order), demod_freqs=freqs)
    want = np.asarray(run_sequence_j(SeqJ(lows), order, demod_freqs=freqs,
                                     interpret=True))
    assert tuple(got.shape) == want.shape
    assert torch.equal(got, run_sequence_loop(seq, list(order),
                                              demod_freqs=freqs))
    got = got.numpy()
    if demod:
        assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5
    else:
        assert max(rel(g, w) for g, w in zip(got, want)) <= TOL
