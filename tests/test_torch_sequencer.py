"""Sequence tables: the port's ``Sequencer`` against the JAX package's.

The same tables (built with numpy from fixed seeds, lowered by the JAX
package and carried over with ``convert.lowered_from_jax``) go through
``waveforms_tpu.ops.sequencer.Sequencer`` (Pallas in interpret mode, as
tests/test_sequencer.py runs it on the CPU) and through
``waveforms_tpu_torch.ops.Sequencer(device='cpu')``, whose kernels run as
their plain versions (K1 ``dense_walk``, K7 ``sparse_walk``, K2
``panel_walk``).  Also here: the entry points that take ``device``
default to the card.

Tolerances and why:

* stacked tensors, merged ext, rewritten ext offsets, sparse worklists and
  the packed plan: array-equal (the same host construction), opcodes
  modulo the JAX table's compact remap (the port keeps the lowering's
  numbers, which its kernels switch on);
* samples: within 1e-6 of each channel's peak of the JAX result (both f32,
  same formulas, different summation and transcendental code) and the JAX
  suite's 2e-6 of the float64 oracle (5e-6 on the multi-tone DRAG table,
  tests/test_pallas_synth.py's limit for it);
* int16 codes: within one code of JAX's (the f32 sums they quantize may
  differ in the last bit).
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import waveforms_tpu as wj
from waveforms_tpu.core import WaveVStack as VStackJ
from waveforms_tpu.ops.lowering import UnsupportedFactor as UnsupportedJ
from waveforms_tpu.ops.lowering import lower_schedule as lower_j
from waveforms_tpu.ops.sequencer import Sequencer as SeqJ
import waveforms_tpu_torch as wt
from waveforms_tpu_torch import kernels
from waveforms_tpu_torch.convert import lowered_from_jax
from waveforms_tpu_torch.ops import Sequencer
from waveforms_tpu_torch.ops.lowering import (N_OPS, OP_DRAG_SIN,
                                              OP_INTERP, UnsupportedFactor)
from test_torch_pair import rel
from test_torch_synth import RTOL, TOL_JAX

FS = 2e9
SPAN = 1e-6


def _gates(part='real'):
    """tests/test_sequencer.py's build_lows table (drag_sin with ext)."""
    return [
        [wj.gaussian(100e-9) >> 0.3e-6, wj.cosPulse(80e-9) >> 0.7e-6],
        [0.7 * wj.square(200e-9, edge=20e-9) >> 0.5e-6,
         wj.drag_sin(0.2e9, 22.3e-9, plateau=6.1e-9, delta=3e6,
                     block_freq=(151e6,), phase=0.1) >> 0.4e-6],
        [wj.gaussian(60e-9) * wj.cos(2 * np.pi * 150e6) >> 0.2e-6,
         wj.cosPulse(50e-9) >> 0.8e-6],
    ]


def _bucketed():
    out = []
    for seed in (1, 2, 3):
        r = np.random.default_rng(seed)
        out.append([VStackJ([(0.4 * wj.cosPulse(40e-9) >> o)
                             for o in r.uniform(0, 7e-6, 60)])])
    return out


def _family():
    """tests/test_stack_seq.py's mixed cosPulse / gaussian family."""
    rng = np.random.default_rng(5)
    return [[VStackJ([0.5 * f(50e-9) >> o
                      for o in rng.uniform(0, 7e-6, 10)])]
            for f in (wj.cosPulse, wj.gaussian)]


def _multichannel():
    """tests/test_stack_seq.py's multichannel table."""
    rng = np.random.default_rng(17)
    return [[VStackJ([0.5 * wj.cosPulse(50e-9) >> o
                      for o in rng.uniform(0, 7e-6, 15)])
             for _ in range(3)] for _ in range(2)]


#: name -> (schedules' channels, stop, lowering kwargs, oracle tolerance)
TABLES = {
    'gates': (_gates, SPAN, {}, 5e-6),
    'complex': (lambda: _gates(), SPAN, {'part': 'complex'}, RTOL),
    'bucketed': (_bucketed, 8.192e-6, {'bucket_samples': 2048}, RTOL),
    'family': (_family, 8.192e-6, {}, RTOL),
    'multichannel': (_multichannel, 8.192e-6, {}, RTOL),
}


@lru_cache(maxsize=None)
def table(name):
    """(channels per schedule, JAX lowerings, JAX Sequencer, port
    Sequencer on the CPU, stop, part)."""
    build, stop, kw, _ = TABLES[name]
    chans = build()
    lows = [lower_j(ch, 0.0, stop, FS, **kw) for ch in chans]
    seq_t = Sequencer([lowered_from_jax(low) for low in lows], device='cpu')
    return chans, lows, SeqJ(lows), seq_t, stop, kw.get('part', 'real')


@lru_cache(maxsize=None)
def oracle(name, k):
    chans, _, _, _, stop, part = table(name)
    return np.asarray(wj.synthesize(chans[k], 0.0, stop, FS, engine='numpy',
                                    part=part))


def check(got, ref, name, ks):
    """got (n, C, N) or (C, N) against the JAX result and the oracle."""
    got = got.numpy()
    assert rel(got, np.asarray(ref)) <= TOL_JAX
    want = np.stack([oracle(name, k) for k in ks])
    assert rel(got.reshape(want.shape), want) <= TABLES[name][3]


def clamp(ks, K):
    return [min(max(int(k), 0), K - 1) for k in ks]


# ---- the table and the plans, array-equal ---------------------------------

@pytest.mark.parametrize('name', list(TABLES))
def test_stacked_tensors_match_jax(name):
    _, lows, sj, st, _, _ = table(name)
    K = len(lows)
    C, NB, Sb, T, F = st.shape
    assert st.shape == sj.shape and st.ops_present == sj.ops_present
    assert st._clip_uniform == sj._clip_uniform and st.pair == sj.pair
    remap = np.zeros(N_OPS, np.int64)
    remap[list(sj.ops_present)] = np.arange(len(sj.ops_present))
    seg, fac = (K, C, NB, Sb), (K, C, NB, Sb, T, F)
    for i, (attr, shape) in enumerate([
            ('seg_lo', seg), ('seg_hi', seg), ('seg_hmax', seg),
            ('nterm', seg), ('nfac', seg + (T,)), ('amp', seg + (T,)),
            ('op', fac), ('power', fac), ('shift_hi', fac),
            ('q32', fac + (4,)), ('args', fac + (12,))]):
        got = getattr(st, attr).numpy()
        if attr == 'op':
            got = remap[got]
        np.testing.assert_array_equal(
            got, np.asarray(sj.tensors[i]).reshape(shape), err_msg=attr)
    np.testing.assert_array_equal(st.clip.numpy(),
                                  np.asarray(sj.tensors[12]).reshape(K, C, 2))
    ext_j = np.asarray(sj.tensors[11]).reshape(-1)
    n = st.ext.shape[0]
    np.testing.assert_array_equal(st.ext.numpy(), ext_j[:n])
    assert not ext_j[n:].any()
    if st.pair:
        np.testing.assert_array_equal(
            st.amp_im.numpy(), np.asarray(sj.amp_im).reshape(seg + (T,)))


def test_ext_offsets_point_into_the_merged_buffer():
    """Each drag_sin factor's rewritten offset reads its own schedule's ext
    block from the table-wide buffer."""
    _, lows, _, st, _, _ = table('gates')
    found = 0
    for k, low in enumerate(lows):
        for pos in np.argwhere(low.op == OP_DRAG_SIN):
            p = tuple(pos)
            off, ln = int(low.args[p + (7,)]), int(low.args[p + (8,)])
            goff = int(st.args[(k,) + p + (7,)])
            np.testing.assert_array_equal(
                st.ext[goff:goff + ln].numpy(),
                np.asarray(low.ext[off:off + ln], np.float32))
            found += 1
    assert found


@pytest.mark.parametrize('name', ['gates', 'family', 'multichannel'])
def test_sparse_table_matches_jax(name):
    _, _, sj, st, _, _ = table(name)
    fields_j, n_tiles_j = sj._sparse_table(8)
    fields_t, n_tiles_t, _ = st._sparse_table(8)
    assert n_tiles_t == n_tiles_j and set(fields_t) == set(fields_j)
    for f in fields_j:
        np.testing.assert_array_equal(fields_t[f].numpy(),
                                      np.asarray(fields_j[f]), err_msg=f)


@pytest.mark.parametrize('name,n_shots', [('gates', 5), ('family', 3),
                                          ('multichannel', 4)])
def test_packed_plan_matches_jax(name, n_shots):
    _, _, sj, st, _, _ = table(name)
    pj, pt = sj._packed_plan(n_shots, 8), st._packed_plan(n_shots, 8)
    for f in ('P', 'NP', 'tps', 'pad', 'n_items', 'n_union'):
        assert getattr(pt, f) == getattr(pj, f), f
    for f in ('start', 'wt', 'wo', 'shot_of', 'u_of', 'rng0_u', 'rng1_u'):
        np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                      np.asarray(getattr(pj, f)), err_msg=f)


# ---- outputs against JAX and the oracle ----------------------------------

@pytest.mark.parametrize('name', list(TABLES))
def test_play_matches_jax_and_oracle(name):
    _, lows, sj, st, _, part = table(name)
    n = kernels.synth_dense.launches
    for k in range(len(lows)):
        got = st.play(k)
        assert got.dtype == (torch.complex64 if part == 'complex'
                             else torch.float32)
        check(got, sj.play(k, rows_per_tile=8, interpret=True), name, [k])
    assert kernels.synth_dense.launches == n        # plain versions only


@pytest.mark.parametrize('name', ['gates', 'bucketed'])
def test_play_int16_codes_match_jax(name):
    _, _, sj, st, _, _ = table(name)
    for k in (0, 2):
        got = st.play(k, out_dtype=torch.int16, dac_scale=30000.0).numpy()
        ref = np.asarray(sj.play(k, rows_per_tile=8, interpret=True,
                                 out_dtype=jnp.int16, dac_scale=30000.0))
        assert got.dtype == np.int16 and ref.dtype == np.int16
        assert np.abs(got.astype(int) - ref).max() <= 1


@pytest.mark.parametrize('name,sparse', [('gates', False), ('gates', True),
                                         ('complex', False),
                                         ('multichannel', True)])
def test_play_many_matches_jax(name, sparse):
    _, lows, sj, st, _, _ = table(name)
    ks = [2, 0, 1, 2] if len(lows) == 3 else [1, 0, 1]
    got = st.play_many(ks, sparse=sparse, Rs=8)
    ref = sj.play_many(np.array(ks), rows_per_tile=8, sparse=sparse, Rs=8,
                       interpret=True)
    assert tuple(got.shape) == (len(ks),) + st.shape[:1] + (st.n_samples,)
    check(got, ref, name, ks)


@pytest.mark.parametrize('name', ['gates', 'family', 'multichannel'])
def test_play_sparse_matches_jax(name):
    _, lows, sj, st, _, _ = table(name)
    n = kernels.synth_sparse.launches
    for k in range(len(lows)):
        check(st.play_sparse(k, Rs=8), sj.play_sparse(k, Rs=8,
                                                      interpret=True),
              name, [k])
    assert kernels.synth_sparse.launches == n


@pytest.mark.parametrize('name', ['gates', 'family', 'multichannel'])
def test_play_packed_matches_jax_and_clamps(name):
    _, lows, sj, st, _, _ = table(name)
    ks = [1, 99, -3, 0, 1]
    got = st.play_packed(ks, Rs=8)
    ref = sj.play_packed(np.array(ks, np.int32), Rs=8, interpret=True)
    assert tuple(got.shape) == (len(ks),) + st.shape[:1] + (st.n_samples,)
    check(got, ref, name, clamp(ks, len(lows)))


def test_play_packed_int16_codes_match_jax():
    _, _, sj, st, _, _ = table('gates')
    ks = [0, 2, 5]
    got = st.play_packed(ks, Rs=8, out_dtype=np.int16).numpy()
    ref = np.asarray(sj.play_packed(np.array(ks), Rs=8, interpret=True,
                                    out_dtype=jnp.int16))
    assert got.dtype == np.int16
    assert np.abs(got.astype(int) - ref).max() <= 1


def test_play_replay_matches_jax_and_clamps():
    _, lows, sj, st, _, _ = table('gates')
    ks = [2, 0, 99, -1]
    got = st.play_replay(ks)
    check(got, sj.play_replay(np.array(ks, np.int32), interpret=True),
          'gates', clamp(ks, len(lows)))


def test_play_replay_per_channel_dac_scale():
    _, _, sj, st, _, _ = table('gates')
    scales = np.linspace(500.0, 1500.0, st.shape[0])
    ks = [1, 0]
    got = st.play_replay(ks, out_dtype=torch.int16, dac_scale=scales)
    ref = np.asarray(sj.play_replay(np.array(ks), interpret=True,
                                    out_dtype=jnp.int16, dac_scale=scales))
    assert got.dtype == torch.int16
    assert np.abs(got.numpy().astype(int) - ref).max() <= 1
    # scalar and vector scales are palettes of their own
    assert st.play_replay(ks, out_dtype=torch.int16,
                          dac_scale=1000.0).dtype == torch.int16
    assert len(st._palettes) >= 2


@pytest.mark.parametrize('method', ['play', 'play_sparse', 'play_replay'])
def test_indices_clamp_at_both_ends(method):
    """k = 99 plays the last schedule and k = -1 schedule 0, as JAX's
    mode='clip' gathers do (never Python's wrap-around to the last)."""
    _, lows, _, st, _, _ = table('gates')
    K = len(lows)
    play = getattr(st, method)
    if method == 'play_replay':
        got = list(play([99, -1, K - 1, 0]))
    else:
        got = [play(k) for k in (99, -1, K - 1, 0)]
    assert torch.equal(got[0], got[2]) and torch.equal(got[1], got[3])
    assert not torch.equal(got[1], got[2])


# ---- refusals --------------------------------------------------------------

@pytest.mark.parametrize('side', ['jax', 'port'])
def test_semantic_refusals_match_jax(side):
    """The JAX Sequencer's refusals on semantics, with its exception types
    and message words, on both sides."""
    if side == 'jax':
        make, unsupported = SeqJ, UnsupportedJ

        def carry(low):
            return low

        def play_kw():
            return {'interpret': True}
    else:
        def make(lows):
            return Sequencer(lows, device='cpu')
        unsupported = UnsupportedFactor
        carry = lowered_from_jax

        def play_kw():
            return {}
    g = [wj.gaussian(100e-9) >> 0.3e-6]
    a = carry(lower_j(g, 0, SPAN, FS))
    with pytest.raises(ValueError, match='share'):
        make([a, carry(lower_j(g, 0, SPAN / 2, FS))])
    with pytest.raises(ValueError, match='empty'):
        make([])
    with pytest.raises(ValueError, match='mix'):
        make([a, carry(lower_j(g, 0, SPAN, FS, part='complex'))])
    bad = carry(lower_j(g, 0, SPAN, FS))
    bad.op[0, 0, 0, 0, 0] = OP_INTERP          # outside the kernels' set
    if side == 'jax':
        bad.pallas_ok = False                  # what the lowering records
    with pytest.raises(unsupported):
        make([bad])
    pair = make([carry(lower_j(g, 0, SPAN, FS, part='complex'))])
    with pytest.raises(unsupported, match='real-only'):
        pair.play_sparse(0, **play_kw())
    with pytest.raises(unsupported, match='real-only'):
        pair.play_packed(np.array([0]), **play_kw())
    with pytest.raises(ValueError, match='f32'):
        pair.play(0, out_dtype=np.int16, **play_kw())
    bucketed = make([carry(lower_j(g, 0, SPAN, FS, bucket_samples=1024))])
    with pytest.raises(unsupported, match='single-bucket'):
        bucketed.play_sparse(0, **play_kw())
    with pytest.raises(unsupported, match='single-bucket'):
        bucketed.play_packed(np.array([0]), **play_kw())
    seq = make([a, carry(lower_j([wj.cut(g[0], max=0.5)], 0, SPAN, FS))])
    with pytest.raises(unsupported, match='uniform clip'):
        seq.play_packed(np.array([0]), **play_kw())
    with pytest.raises(NotImplementedError, match='f32-only'):
        seq.play_many(np.array([0, 1]), sparse=True, out_dtype=np.int16,
                      **play_kw())
    with pytest.raises(unsupported, match='palette'):
        seq.play_replay(np.array([0]), max_palette_bytes=16, **play_kw())


def test_smem_budget_of_a_descriptor_block_is_not_carried_over():
    """60 overlapping pulses give 117 segments of up to 60 terms: the
    descriptor block exceeds the TPU's SMEM budget, so the JAX Sequencer
    refuses the table; the port plays it (its descriptors live in global
    memory)."""
    rng = np.random.default_rng(0)
    chans = [sum((0.02 * wj.gaussian(400e-9) * wj.cos(2 * np.pi * f)
                  >> float(o) for f, o in zip(np.linspace(50e6, 250e6, 60),
                                              rng.uniform(0.3e-6, 0.7e-6,
                                                          60))),
                 wj.zero())]
    low = lower_j(chans, 0.0, SPAN, FS, bucket_samples=None)
    assert not low.pallas_ok
    with pytest.raises(UnsupportedJ):
        SeqJ([low])
    st = Sequencer([lowered_from_jax(low)], device='cpu')
    want = np.asarray(wj.synthesize(chans, 0.0, SPAN, FS, engine='numpy'))
    assert rel(st.play(0).numpy(), want) <= RTOL
    assert rel(st.play_packed([0, 0], Rs=8)[1].numpy(), want) <= RTOL


def test_packed_budget_of_the_concatenated_table_is_not_carried_over():
    """Sixteen 200-pulse schedules concatenate past the TPU's SMEM budget
    for play_packed; the JAX Sequencer refuses the launch, the port plays
    it."""
    rng = np.random.default_rng(21)
    chans = [[VStackJ([(0.4 * wj.cosPulse(40e-9) >> o)
                       for o in rng.uniform(0, 7e-6, 200)])]
             for _ in range(16)]
    lows = [lower_j(ch, 0.0, 8.192e-6, FS, bucket_samples=None)
            for ch in chans]
    with pytest.raises(UnsupportedJ, match='SMEM'):
        SeqJ(lows).play_packed(np.array([0]), interpret=True)
    st = Sequencer([lowered_from_jax(low) for low in lows], device='cpu')
    ks = [15, 7]
    got = st.play_packed(ks, Rs=8).numpy()
    for i, k in enumerate(ks):
        want = np.asarray(wj.synthesize(chans[k], 0.0, 8.192e-6, FS,
                                        engine='numpy'))
        assert rel(got[i], want) <= RTOL


# ---- the entry points default to the card ---------------------------------

def _entry_points():
    from waveforms_tpu_torch.ops import hi_synth, stack_seq, stack_synth
    from waveforms_tpu_torch.ops.synth import DeviceSchedule

    def low(keep_f64=False):
        return wt.ops.lowering.lower_schedule(
            [wt.gaussian(1e-6)], -1e-6, 1e-6, 1e9, keep_f64=keep_f64)

    def stack_low():
        rng = np.random.default_rng(1)
        return wt.ops.lowering.lower_schedule(
            [wt.WaveVStack([(0.5 * wt.cosPulse(50e-9) >> o)
                            for o in rng.uniform(0, 7e-6, 20)])],
            0.0, 8.192e-6, 2e9)

    def stack_tables():
        s = stack_low()
        return stack_synth.build_stack_tables(stack_synth.build_stack_plan(s),
                                              s)
    return {
        'DeviceSchedule': lambda: DeviceSchedule(low()),
        'HiSchedule': lambda: hi_synth.HiSchedule(low(True)),
        'synthesize_hi': lambda: hi_synth.synthesize_hi(low(True)),
        'synthesize_hi_panels': lambda: hi_synth.synthesize_hi_panels(
            low(True)),
        'synthesize_hi_routed': lambda: hi_synth.synthesize_hi_routed(
            low(True)),
        'synthesize_stack': lambda: stack_synth.synthesize_stack(stack_low()),
        'build_stack_tables': stack_tables,
        'synthesize': lambda: wt.synthesize([wt.gaussian(1e-6)], -1e-6,
                                            1e-6, 1e9),
        'Sequencer': lambda: Sequencer([low()]),
        'StackSequencer': lambda: stack_seq.StackSequencer([stack_low()]),
    }


@pytest.mark.parametrize('entry', list(_entry_points()))
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Called without ``device``, every entry point asks for the card and,
    with no CUDA device, raises instead of returning CPU tensors."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        _entry_points()[entry]()
