"""The port's sharded stacked-table paths against the JAX package's.

``synthesize_stack_sharded`` (K6 over a window of chunks, one launch a
shard) and ``StackSequencer.play_packed_sharded`` of
``waveforms_tpu_torch.ops.stack_seq`` on meshes that name the CPU eight
times (the kernel's plain version ``reference.stack_seq_eval``), against
the same functions of ``waveforms_tpu.ops.stack_seq`` on the JAX package's
8-device CPU mesh in interpret mode, as tests/test_stack_seq.py runs them.
Each port result equals the port's own single-device playback of the same
tables bit for bit and lies within 1e-6 of each channel's peak of JAX's
(int16 within one code) and within 2e-6 of the float64 oracle.  K6's
plain version over a window equals the same columns of its whole-table
output bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import waveforms_tpu as wj
import waveforms_tpu.ops.stack_seq as ssj
from waveforms_tpu.core import WaveVStack as VStackJ
from waveforms_tpu_torch import kernels
from waveforms_tpu_torch.convert import waveform_from_jax
from waveforms_tpu_torch.ops.lowering import UnsupportedFactor, \
    lower_schedule
from waveforms_tpu_torch.ops.stack_seq import (StackSequencer,
                                               synthesize_stack_sharded)
from waveforms_tpu_torch.ops.stack_synth import CTA_CHUNKS
from test_torch_mesh import FS, mesh_j, mesh_t, np_of, vstack_channels
from test_torch_synth import RTOL, TOL_JAX, oracle, rel

STOP = 8.192e-6


def _port(chans):
    return [waveform_from_jax(c) for c in chans]


@pytest.mark.parametrize('nc, nt, n_channels, seed', [
    (4, 2, 4, 3), (1, 8, 1, 9), (2, 4, 2, 21), (2, 4, 8, 5)])
def test_stack_sharded_matches_jax_and_oracle(nc, nt, n_channels, seed):
    """Channel x time meshes (the JAX suite's test_stack_sharded_matches_
    oracle and _time_only_single_channel shapes), over a span of 32,768
    samples so that the time shards split real chunks."""
    stop = 4 * STOP
    chans = vstack_channels(n_channels, n_pulses=60, seed=seed, stop=stop)
    plane = synthesize_stack_sharded(_port(chans), 0, stop, FS,
                                     mesh_t(nc, nt))
    assert len(plane.blocks) == nc and len(plane.blocks[0]) == nt
    got = plane.gather()
    cs = n_channels // nc
    whole = torch.cat([StackSequencer(
        [lower_schedule(_port(chans[i * cs:(i + 1) * cs]), 0, stop, FS,
                        bucket_samples=None)], device='cpu').play(0)
        for i in range(nc)])
    assert torch.equal(got, whole)
    ref = np.asarray(ssj.synthesize_stack_sharded(chans, 0, stop, FS,
                                                  mesh_j(nc, nt),
                                                  interpret=True))
    assert rel(got.numpy(), ref) <= TOL_JAX
    assert rel(got.numpy(), oracle(chans, 0, stop, FS)) <= RTOL


def test_stack_sharded_int16_codes():
    chans = vstack_channels(2, seed=21)
    f32 = synthesize_stack_sharded(_port(chans), 0, STOP, FS,
                                   mesh_t(2, 4)).gather()
    codes = synthesize_stack_sharded(_port(chans), 0, STOP, FS, mesh_t(2, 4),
                                     out_dtype=torch.int16,
                                     dac_scale=1000.0).gather()
    assert codes.dtype == torch.int16
    want = torch.clamp(torch.round(f32 * 1000.0), -32768, 32767)
    assert torch.equal(codes, want.to(torch.int16))
    ref = np.asarray(ssj.synthesize_stack_sharded(
        chans, 0, STOP, FS, mesh_j(2, 4), interpret=True,
        out_dtype=jnp.int16, dac_scale=1000.0))
    assert np.abs(codes.numpy().astype(int) - ref).max() <= 1


def test_stack_sharded_refusals():
    """UnsupportedFactor where JAX raises it: channels that do not split
    over the channel shards, wide instances, a per-channel int16 scale."""
    chans = _port(vstack_channels(3))
    with pytest.raises(UnsupportedFactor, match='do not split'):
        synthesize_stack_sharded(chans, 0, STOP, FS, mesh_t(2, 4))
    rng = np.random.default_rng(4)
    wide = _port([VStackJ([0.5 * wj.cosPulse(50e-9) >> o
                           for o in rng.uniform(0, 7e-6, 30)]
                          + [0.2 * wj.square(4e-6) >> 4e-6])] * 2)
    with pytest.raises(UnsupportedFactor, match='wide'):
        synthesize_stack_sharded(wide, 0, STOP, FS, mesh_t(2, 4))
    with pytest.raises(UnsupportedFactor, match='scalar dac_scale'):
        synthesize_stack_sharded(_port(vstack_channels(2)), 0, STOP, FS,
                                 mesh_t(2, 4), out_dtype=torch.int16,
                                 dac_scale=[1000.0, 2000.0])


def test_stack_sharded_table_scales_inverse_nc():
    """Each channel shard's table holds its own channels' instances only
    (bytes 1/nc of one table over every channel), and n_super_multiple
    rounds the thread-block groups up to whole multiples of the time
    shards (the JAX suite's test_stack_sharded_work_scales_inverse_p)."""
    chans = _port(vstack_channels(4, seed=5))
    lows = [lower_schedule([c], 0, STOP, FS, bucket_samples=None)
            for c in chans]
    seqs = [StackSequencer([low], device='cpu', n_super_multiple=3)
            for low in lows]
    whole = StackSequencer([lower_schedule(chans, 0, STOP, FS,
                                           bucket_samples=None)],
                           device='cpu')
    assert sum(s.tables.inst.shape[0] for s in seqs) == \
        whole.tables.inst.shape[0]
    assert sum(s.tables.n_blocks for s in seqs) == whole.tables.n_blocks
    groups = -(-whole.tables.n_chunks // CTA_CHUNKS)
    assert seqs[0].n_super == -(-groups // 3) * 3 and seqs[0].n_super % 3 == 0


@pytest.mark.parametrize('dtype', ['float32', 'int16'])
def test_play_packed_sharded_equals_play_packed(dtype):
    """Shots split over the mesh's 8 devices in mesh order, shots past both
    ends of the table and a count that does not divide: equal to
    play_packed bit for bit, and within 1e-6 (one code) of JAX's."""
    from test_stack_seq import _table
    lows_j, _ = _table(n_schedules=3, n_pulses=40, seed=11)
    from waveforms_tpu_torch.convert import lowered_from_jax
    seq = StackSequencer([lowered_from_jax(x) for x in lows_j],
                         device='cpu')
    ks = [2, 0, 99, -3, 1, 1, 0, 2, 2, 1, 0]
    tdt = torch.int16 if dtype == 'int16' else None
    plane = seq.play_packed_sharded(ks, mesh_t(4, 2), out_dtype=tdt,
                                    dac_scale=1000.0)
    assert len(plane.blocks) == 8
    got = plane.gather()
    assert got.shape == (len(ks), seq.n_channels, seq.n_samples)
    assert torch.equal(got, seq.play_packed(ks, out_dtype=tdt,
                                            dac_scale=1000.0))
    # the table is copied to each device once and kept
    assert seq.tables_on('cpu') is seq.tables
    ref = np_of(ssj.StackSequencer(lows_j).play_packed_sharded(
        jnp.asarray(ks, jnp.int32), mesh_j(4, 2), interpret=True,
        out_dtype=jnp.int16 if tdt else None, dac_scale=1000.0))
    got = got.numpy()
    if tdt:
        assert np.abs(got.astype(int) - ref).max() <= 1
    else:
        assert rel(got.reshape(-1, got.shape[-1]),
                   ref.reshape(-1, ref.shape[-1])) <= TOL_JAX


@pytest.mark.parametrize('chunk0, count', [(0, 4), (4, 4), (8, None),
                                           (3, 1)])
def test_stack_seq_eval_window_equals_whole_columns(chunk0, count):
    """K6's plain version over chunks [chunk0, chunk0 + count) equals the
    same columns of its whole-table output bit for bit, f32 and int16."""
    stop = 49.9e-6                        # 13 chunks, the last ragged
    chans = _port(vstack_channels(3, n_pulses=40, seed=8, stop=stop))
    lows = [lower_schedule(chans, 0, stop, FS, bucket_samples=None),
            lower_schedule(chans[::-1], 0, stop, FS, bucket_samples=None)]
    seq = StackSequencer(lows, device='cpu')
    t, n = seq.tables, lows[0].n_samples
    ks = torch.tensor([1, 0, 1], dtype=torch.int32)
    span = 64 * 128
    count = t.n_chunks - chunk0 if count is None else count
    a, b = chunk0 * span, min(n, (chunk0 + count) * span)
    for dtype, scale in ((torch.float32, None),
                         (torch.int16, torch.full((3,), 3000.0))):
        whole = kernels.synth_stack_seq(t, ks, torch.empty((3, 3, n),
                                                           dtype=dtype),
                                        scale)
        got = kernels.synth_stack_seq(t, ks, torch.empty((3, 3, b - a),
                                                         dtype=dtype),
                                      scale, chunk0, count)
        assert torch.equal(got, whole[..., a:b])
    with pytest.raises(ValueError, match='outside'):
        kernels.synth_stack_seq(t, ks, torch.empty((3, 3, 1)), None,
                                t.n_chunks, 1)
