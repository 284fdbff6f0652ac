"""Stacked-table playback: the port's ``StackSequencer`` (K6) against the
JAX package's.

The same narrow-pulse tables (numpy from fixed seeds, tests/test_stack_seq.py's
constructions, lowered by the JAX package and carried over with
``convert.lowered_from_jax``) go through
``waveforms_tpu.ops.stack_seq.StackSequencer`` (Pallas in interpret mode,
as tests/test_stack_seq.py runs it on the CPU) and through
``waveforms_tpu_torch.ops.StackSequencer(device='cpu')``, where the
sequenced stack kernel (``csrc/synth_stack_seq.cu``) runs as its plain
version ``ops.reference.stack_seq_eval``.

Tolerances and why: the stacked tables are array-equal to each schedule's
own K5 tables (the same host construction, offsets added); samples within
1e-6 of each channel's peak of the JAX result (both f32; K6 adds blocks in
table order, JAX in its one-hot matmul order) and the JAX suite's 2e-6 of
the float64 oracle; int16 codes within one code of JAX's.
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
from waveforms_tpu.ops.stack_seq import StackSequencer as StackSeqJ
from waveforms_tpu_torch import kernels
from waveforms_tpu_torch.convert import lowered_from_jax
from waveforms_tpu_torch.ops import StackSequencer
from waveforms_tpu_torch.ops.lowering import (OP_DRAG_SIN, OP_DRAG_SINX,
                                              UnsupportedFactor)
from waveforms_tpu_torch.ops.stack_synth import (build_stack_plan,
                                                 build_stack_tables,
                                                 synthesize_stack)
from test_torch_synth import RTOL, TOL_JAX, rel

FS = 2e9
STOP = 8.192e-6


def _vstacks(n_schedules, n_pulses, seed, n_channels=1, family=None):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_schedules):
        out.append([VStackJ([
            (float(a) * (family or wj.cosPulse)(50e-9) >> o)
            for a, o in zip(rng.uniform(0.2, 1.0, n_pulses),
                            rng.uniform(0, STOP - 1e-7, n_pulses))])
            for _ in range(n_channels)])
    return out


def _mixed_family():
    rng = np.random.default_rng(5)
    return [[VStackJ([0.5 * f(50e-9) >> o
                      for o in rng.uniform(0, 7e-6, 10)])]
            for f in (wj.cosPulse, wj.gaussian)]


def _drag_sin():
    """Multi-tone DRAG trains: ext reads through the rewritten offsets."""
    rng = np.random.default_rng(41)
    out = []
    for n in (6, 9):
        x = wj.zero()
        p = wj.drag_sin(5e9, 20e-9, plateau=10e-9, delta=1e6,
                        block_freq=(151e6,), phase=float(rng.uniform(0, 6)))
        for o in np.sort(rng.uniform(0, 7e-6, n)):
            x += p >> float(o)
        out.append([x])
    return out


#: name -> channels per schedule
TABLES = {
    'vstack3': lambda: _vstacks(3, 40, 11),
    'mixed_family': _mixed_family,
    'multichannel': lambda: _vstacks(2, 15, 17, n_channels=3),
    'drag_sin': _drag_sin,
}


@lru_cache(maxsize=None)
def table(name):
    """(channels per schedule, JAX lowerings, port lowerings, port
    StackSequencer on the CPU)."""
    chans = TABLES[name]()
    lows = [lower_j(ch, 0.0, STOP, FS) for ch in chans]
    lows_t = [lowered_from_jax(low) for low in lows]
    return chans, lows, lows_t, StackSequencer(lows_t, device='cpu')


@lru_cache(maxsize=None)
def oracle(name, k):
    return np.asarray(wj.synthesize(table(name)[0][k], 0.0, STOP, FS,
                                    engine='numpy'))


@pytest.mark.parametrize('name', list(TABLES))
def test_stacked_tables_hold_each_schedules_k5_tables(name):
    """Schedule k's slice of the stacked tables is its own K5 table with
    the instance, block and ext bases added."""
    _, _, lows_t, st = table(name)
    t = st.tables
    assert t.chunk_start.shape == (len(lows_t),
                                   t.n_channels * t.n_chunks + 1)
    m0 = b0 = e0 = 0
    for k, low in enumerate(lows_t):
        own = build_stack_tables(build_stack_plan(low), low, 'cpu')
        M, B, E = own.inst.shape[0], own.n_blocks, own.ext.shape[0]
        np.testing.assert_array_equal(t.inst[m0:m0 + M], own.inst)
        np.testing.assert_array_equal(t.amp[m0:m0 + M, :own.NT], own.amp)
        np.testing.assert_array_equal(t.op[m0:m0 + M, :own.TF], own.op)
        np.testing.assert_array_equal(t.blk_inst[b0:b0 + B],
                                      own.blk_inst + m0)
        np.testing.assert_array_equal(t.blk_row[b0:b0 + B], own.blk_row)
        np.testing.assert_array_equal(t.chunk_start[k], own.chunk_start + b0)
        np.testing.assert_array_equal(t.ext[e0:e0 + E], own.ext)
        drag = np.isin(own.op.numpy(), (OP_DRAG_SIN, OP_DRAG_SINX))
        args = t.args[m0:m0 + M, :own.TF].numpy()
        np.testing.assert_array_equal(args[..., 7][drag],
                                      own.args[..., 7].numpy()[drag] + e0)
        np.testing.assert_array_equal(args[..., :7],
                                      own.args[..., :7].numpy())
        m0, b0, e0 = m0 + M, b0 + B, e0 + E
    assert (m0, b0, e0) == (t.inst.shape[0], t.n_blocks, t.ext.shape[0])
    if name == 'drag_sin':
        assert np.isin(t.op.numpy(), (OP_DRAG_SIN, OP_DRAG_SINX)).any()


@pytest.mark.parametrize('name', list(TABLES))
def test_play_packed_matches_jax_and_oracle(name):
    _, lows, _, st = table(name)
    K = len(lows)
    ks = [K - 1, 0, 99, -3, 1]
    n = kernels.synth_stack_seq.launches
    got = st.play_packed(ks)
    assert kernels.synth_stack_seq.launches == n     # plain version only
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (len(ks), lows[0].shape[0], lows[0].n_samples)
    ref = np.asarray(StackSeqJ(lows).play_packed(ks, interpret=True))
    assert rel(got.numpy(), ref) <= TOL_JAX
    for i, k in enumerate(ks):
        assert rel(got[i].numpy(),
                   oracle(name, min(max(k, 0), K - 1))) <= RTOL, i


def test_play_and_clamping_at_both_ends():
    _, _, _, st = table('vstack3')
    K = st.n_schedules
    got = st.play_packed([99, -1, K - 1, 0])
    assert torch.equal(got[0], got[2]) and torch.equal(got[1], got[3])
    assert not torch.equal(got[1], got[2])
    assert torch.equal(st.play(1), st.play_packed([1])[0])
    assert torch.equal(st.play(-7), got[3])


def test_play_packed_matches_per_schedule_stack_synthesis():
    """A shot equals the single-schedule stack route on its schedule (K5's
    plain version), sample for sample."""
    _, _, lows_t, st = table('multichannel')
    got = st.play_packed([1, 0])
    for i, k in enumerate([1, 0]):
        assert torch.equal(got[i], synthesize_stack(lows_t[k], device='cpu'))


def test_play_packed_int16_codes_match_jax():
    _, lows, _, st = table('vstack3')
    ks = [0, 2, 1]
    codes = st.play_packed(ks, out_dtype=torch.int16, dac_scale=1000.0)
    ref = np.asarray(StackSeqJ(lows).play_packed(
        ks, interpret=True, out_dtype=jnp.int16, dac_scale=1000.0))
    assert codes.dtype == torch.int16 and ref.dtype == np.int16
    assert np.abs(codes.numpy().astype(int) - ref).max() <= 1
    f32 = st.play_packed(ks).double()
    want = torch.clamp(torch.round(f32 * 1000.0), -32768, 32767)
    assert torch.equal(codes, want.to(torch.int16))


@pytest.mark.parametrize('side', ['jax', 'port'])
def test_semantic_refusals_match_jax(side):
    """The JAX StackSequencer's refusals, with its exception types and
    message words, on both sides."""
    if side == 'jax':
        make, carry, unsupported = StackSeqJ, (lambda low: low), UnsupportedJ

        def plans_of(lows):
            import waveforms_tpu.ops.stack_synth as sj
            return [sj.build_stack_plan(low) for low in lows]
    else:
        def make(lows, plans=None):
            return StackSequencer(lows, plans, device='cpu')
        carry, unsupported = lowered_from_jax, UnsupportedFactor

        def plans_of(lows):
            return [build_stack_plan(low) for low in lows]
    chans = _vstacks(2, 10, 31)
    lows = [carry(lower_j(ch, 0.0, STOP, FS)) for ch in chans]
    with pytest.raises(ValueError, match='empty'):
        make([])
    with pytest.raises(ValueError, match='share'):
        make([lows[0], carry(lower_j(chans[1], 0.0, STOP / 2, FS))])
    with pytest.raises(unsupported, match='single-bucket'):
        make([carry(lower_j(chans[0], 0.0, STOP, FS, bucket_samples=4096))])
    with pytest.raises(unsupported, match='batchable'):
        make([carry(lower_j([wj.gaussian(2e-6) >> 4e-6], 0.0, STOP, FS))])
    wide = wj.zero()
    wide += 0.3 * wj.square(6e-6) >> 4e-6
    wide += 0.5 * wj.cosPulse(50e-9) >> 1e-6
    with pytest.raises(unsupported, match='wide'):
        make([lows[0], carry(lower_j([wide], 0.0, STOP, FS))])
    plans = plans_of(lows)
    with pytest.raises(ValueError, match='1:1'):
        make(lows, plans[:1])
    with pytest.raises(ValueError, match='1:1'):
        make(lows[:1], plans)
    short = [carry(lower_j(ch, 0.0, STOP / 2, FS)) for ch in chans]
    with pytest.raises(ValueError, match='1:1'):
        make(lows, plans_of(short))
    seq = make(lows)
    kw = {'interpret': True} if side == 'jax' else {}
    with pytest.raises(unsupported, match='scalar dac_scale'):
        seq.play_packed([0], out_dtype=np.int16, dac_scale=[1000.0], **kw)


def test_many_structure_groups_are_not_refused():
    """Nine pulse families give nine factor-structure groups across the
    table: the JAX stacked kernel refuses more than KERNEL_MAX_GROUPS (8),
    the port's concatenated tables take any number."""
    rng = np.random.default_rng(3)
    fams = [wj.cosPulse(50e-9), wj.gaussian(50e-9), wj.cosPulse(50e-9) ** 2,
            wj.gaussian(50e-9) ** 2, wj.cosPulse(50e-9) ** 3,
            wj.gaussian(50e-9) ** 3, wj.gaussian(50e-9) * wj.cos(3e8),
            wj.cosPulse(50e-9) * wj.cos(2e8), wj.gaussian(50e-9) ** 4]
    chans = [[VStackJ([0.5 * f >> o for o in np.sort(
        rng.uniform(0, 7e-6, 6))])] for f in fams]
    lows = [lower_j(ch, 0.0, STOP, FS) for ch in chans]
    with pytest.raises(UnsupportedJ, match='groups'):
        StackSeqJ(lows)
    st = StackSequencer([lowered_from_jax(low) for low in lows],
                        device='cpu')
    ks = list(range(len(fams)))
    got = st.play_packed(ks).numpy()
    for k in ks:
        want = np.asarray(wj.synthesize(chans[k], 0.0, STOP, FS,
                                        engine='numpy'))
        assert rel(got[k], want) <= RTOL, k
