"""The port's mesh (``waveforms_tpu_torch.parallel.mesh``) against the JAX
package's sharded synthesis on its 8-device CPU mesh.

The JAX side runs on ``channel_mesh(nc, nt)`` over the 8 virtual CPU
devices of tests/conftest.py with its kernels in interpret mode, as its own
mesh tests run; the port runs on ``channel_mesh(nc, nt, devices=['cpu'] *
8)``, a mesh that names the CPU eight times, through the kernels' plain
versions.  Every port sharded result equals the port's single-device result
on the same lowering bit for bit (JAX asserts array equality for its own
pair) and lies within 1e-6 of each channel's peak of JAX's sharded result
(f32 and pair mode), int16 codes within one code; bf16 equals the port's
f32 plane rounded once, within one bf16 step of JAX's.  The routing of
``synthesize_on_mesh`` equals JAX's on the JAX suite's routing cases, by
spies on both packages' sharded entry points.  Schedules are small (at most
8 channels, at most 16,384 samples).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import waveforms_tpu as wj
import waveforms_tpu.ops.sparse_synth as sj
import waveforms_tpu.ops.stack_seq as ssj
import waveforms_tpu.parallel.mesh as mj
from waveforms_tpu.core import WaveVStack as VStackJ
from waveforms_tpu.ops.lowering import lower_schedule as lower_j
from waveforms_tpu_torch import parallel
from waveforms_tpu_torch.convert import lowered_from_jax, waveform_from_jax
from waveforms_tpu_torch.ops import sparse_synth, stack_seq
from waveforms_tpu_torch.ops.lowering import lower_schedule
from waveforms_tpu_torch.ops.synth import DeviceSchedule, synthesize_device
from waveforms_tpu_torch.parallel import mesh as mt
from test_torch_synth import RTOL, TOL_JAX, oracle, rel

FS = 2e9


def mesh_j(nc=4, nt=2):
    return mj.channel_mesh(n_channel=nc, n_time=nt)


def mesh_t(nc=4, nt=2):
    return mt.channel_mesh(nc, nt, devices=['cpu'] * (nc * nt))


def np_of(x):
    """A gathered plane (or tensor) as a numpy array, bf16 as f32."""
    if isinstance(x, mt.ShardedPlane):
        x = x.gather()
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def pulses(n=6, amp=0.5):
    return [amp * wj.cosPulse(50e-9) >> (k * 100e-9) for k in range(n)]


def bucketed_stacks():
    rng = np.random.default_rng(5)
    return [VStackJ([(0.3 * wj.cosPulse(40e-9) >> o)
                     for o in rng.uniform(0, 7e-6, 60)]) for _ in range(4)]


def sparse_schedule(n=6, seed=0):
    """tests/test_sparse_synth.py's ``_sparse_schedule``: DRAG-mixed
    20 ns cosPulses on even channels, edge-smoothed squares on odd ones."""
    rng = np.random.default_rng(seed)
    chans = []
    for c in range(n):
        x = wj.zero()
        if c % 2 == 0:
            for _ in range(3):
                I, _ = wj.mixing(0.5 * wj.cosPulse(20e-9)
                                 >> rng.uniform(0, 7e-6),
                                 freq=-150e6 - 2e6 * c, DRAGScaling=1e-10)
                x += I
        else:
            for _ in range(2):
                x += 0.3 * (wj.square(80e-9, edge=10e-9)
                            >> rng.uniform(0, 7e-6))
        chans.append(x)
    return chans


def vstack_channels(n_channels, n_pulses=30, seed=3, stop=8.192e-6):
    """tests/test_stack_seq.py's ``_vstack_channels``."""
    rng = np.random.default_rng(seed)
    return [VStackJ([float(a) * wj.cosPulse(50e-9) >> o
                     for a, o in zip(rng.uniform(0.2, 1.0, n_pulses),
                                     rng.uniform(0, stop - 1e-7, n_pulses))])
            for _ in range(n_channels)]


def bf16_step(x):
    """One bf16 step at |x| (8 significant bits)."""
    x = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def test_channel_mesh_shape_and_devices(monkeypatch):
    m = mesh_t(4, 2)
    assert m.shape == {'channel': 4, 'time': 2}
    assert m.axis_names == ('channel', 'time')
    assert m.size == 8 and m.device(3, 1) == torch.device('cpu')
    assert mt.channel_mesh(n_time=4, devices=['cpu'] * 8).shape == {
        'channel': 2, 'time': 4}
    with pytest.raises(ValueError, match='do not make'):
        mt.channel_mesh(3, 2, devices=['cpu'] * 8)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='every visible GPU'):
        mt.channel_mesh()
    with pytest.raises(RuntimeError, match='no CUDA'):
        mt.channel_mesh(2, 1, devices=['cuda'] * 2)


def _sharded_case(mode):
    """(JAX channels, stop, mesh shape, part, out_dtype (name), dac_scale,
    bucket_samples) of each synthesize_sharded case (the JAX suite's:
    tests/test_pallas_synth.py)."""
    scales = np.array([32767.0, 16000.0, 8000.0, 32767.0], np.float32)
    return {
        'f32': (pulses(), 0.8e-6, (2, 4), 'real', None, 32767.0, 'auto'),
        'pair': ([(0.5 + 0.3j) * w for w in pulses(amp=1.0)], 0.8e-6,
                 (2, 4), 'complex', None, 32767.0, 'auto'),
        'bf16': (pulses(4), 0.8e-6, (2, 4), 'real', 'bfloat16', 32767.0,
                 'auto'),
        'int16': ([0.7 * wj.cosPulse(100e-9) >> (0.3e-6 + 0.2e-6 * k)
                   for k in range(4)], 2.048e-6, (4, 2), 'real', 'int16',
                  scales, 'auto'),
        'bucketed': (bucketed_stacks(), 8.192e-6, (2, 4), 'real', None,
                     32767.0, 2048),
        # 1,600 samples over 8 time shards of 1,024: six shards past the end
        'past_end': (pulses(), 0.8e-6, (1, 8), 'real', None, 32767.0,
                     'auto'),
    }[mode]


@pytest.mark.parametrize('mode', ['f32', 'pair', 'bf16', 'int16',
                                  'bucketed', 'past_end'])
def test_synthesize_sharded_matches_single_device_and_jax(mode):
    chans, stop, (nc, nt), part, dt, scale, bs = _sharded_case(mode)
    low = lower_j(chans, 0, stop, FS, part=part, bucket_samples=bs)
    low_t = lowered_from_jax(low)
    jdt = {'int16': jnp.int16, 'bfloat16': jnp.bfloat16}.get(dt, jnp.float32)
    tdt = {'int16': torch.int16, 'bfloat16': torch.bfloat16}.get(dt)
    plane = mt.synthesize_sharded(low_t, mesh_t(nc, nt), rows_per_tile=8,
                                  out_dtype=tdt, dac_scale=scale)
    assert isinstance(plane, mt.ShardedPlane)
    assert plane.shape == (low.shape[0], low.n_samples)
    assert len(plane.blocks) == nc and len(plane.blocks[0]) == nt
    got = plane.gather()
    single = synthesize_device(DeviceSchedule(low_t, 'cpu'), out_dtype=tdt,
                               dac_scale=scale)
    assert got.dtype == single.dtype and torch.equal(got, single)
    ref = np_of(mj.synthesize_sharded(low, mesh_j(nc, nt), rows_per_tile=8,
                                      interpret=True, out_dtype=jdt,
                                      dac_scale=scale))
    got = np_of(got)
    if mode == 'int16':
        assert np.abs(got.astype(int) - ref).max() <= 1
    elif mode == 'bf16':
        f32 = mt.synthesize_sharded(low_t, mesh_t(nc, nt), rows_per_tile=8)
        assert torch.equal(plane.gather(), f32.gather().to(torch.bfloat16))
        assert (np.abs(got - ref) <= bf16_step(ref)).all()
    elif mode == 'pair':
        assert got.dtype == np.complex64
        assert rel(got.real, ref.real) <= TOL_JAX
        assert rel(got.imag, ref.imag) <= TOL_JAX
    else:
        assert rel(got, ref) <= TOL_JAX
        assert rel(got, oracle(chans, 0, stop, FS)) <= RTOL


def test_shard_schedule_descriptor_bytes_scale_with_devices():
    """Each channel shard holds exactly C/nc channels' descriptors (the
    JAX suite's test_sharded_work_and_bytes_scale_with_devices); time
    shards of a bucketed schedule hold their slice of the bucket axis."""
    rng = np.random.default_rng(7)
    chans = [waveform_from_jax(VStackJ(
        [(wj.cosPulse(50e-9) >> float(rng.uniform(0, 7.9e-6)))
         for _ in range(40)])) for _ in range(8)]
    low = lower_schedule(chans, 0, 8.192e-6, FS, bucket_samples=None)
    whole = DeviceSchedule(low, 'cpu')
    grid, c_pad = mt.shard_schedule(low, mesh_t(4, 2))
    assert c_pad == 8
    for name in DeviceSchedule._TENSORS:
        w = getattr(whole, name)
        if w is None or name == 'ext':
            continue
        assert getattr(grid[0][0], name).nbytes * 4 == w.nbytes, name
    # the two time shards of one channel shard on one device share tensors
    assert grid[1][0].args is grid[1][1].args
    low_b = lowered_from_jax(lower_j(bucketed_stacks(), 0, 8.192e-6, FS,
                                     bucket_samples=2048))
    NB = low_b.shape[1]
    grid, _ = mt.shard_schedule(low_b, mesh_t(2, 4), nb_pad=NB)
    assert grid[0][0].shape[1] == NB // 4
    assert np.array_equal(grid[1][3].op.numpy(),
                          low_b.op[2:4, 3 * NB // 4:])
    assert grid[1][3].n_samples == low_b.n_samples


class Spy:
    """Record which sharded entry point a mesh call took, in either
    package."""

    ROUTES_J = ((sj, 'synthesize_panels_sharded', 'panel'),
                (sj, 'synthesize_sparse_sharded', 'sparse'),
                (ssj, 'synthesize_stack_sharded', 'stack'),
                (mj, 'synthesize_sharded', 'dense'))
    ROUTES_T = ((sparse_synth, 'synthesize_panels_sharded', 'panel'),
                (sparse_synth, 'synthesize_sparse_sharded', 'sparse'),
                (stack_seq, 'synthesize_stack_sharded', 'stack'),
                (mt, 'synthesize_sharded', 'dense'))

    def __init__(self, monkeypatch):
        self.calls = []
        for mod, name, route in self.ROUTES_J + self.ROUTES_T:
            monkeypatch.setattr(mod, name, self.wrap(getattr(mod, name),
                                                     route))

    def wrap(self, fn, route):
        def spy(*a, **kw):
            out = fn(*a, **kw)        # a refusal raises before it counts
            self.calls.append(route)
            return out
        return spy

    def take(self):
        calls, self.calls = self.calls, []
        return calls[-1]


def _routing_cases():
    """(JAX channels, stop, part, out dtype, JAX's route) of the JAX
    suite's routing cases, cut to at most 16,384 samples."""
    return {
        # test_synthesize_on_mesh_routes_panels / ..._int16_and_pair
        'panel_f32': (sparse_schedule(6, seed=12), 8.192e-6, 'real', None,
                      'panel'),
        'panel_int16': (sparse_schedule(6, seed=12), 8.192e-6, 'real',
                        'int16', 'panel'),
        'panel_pair': ([(0.4 + 0.6j) * c for c in sparse_schedule(4, 9)],
                       8.192e-6, 'complex', None, 'panel'),
        # a narrowed store over several local buckets (50 pulses a
        # channel bucket the schedule by 4,096 samples): the panel kernel
        # refuses it on the mesh, and the worklist kernel takes it
        'worklist_narrow_buckets': (
            [VStackJ([0.4 * wj.cosPulse(20e-9)
                      >> (20e-9 + k * 39e-9 + 3e-9 * c) for k in range(50)])
             for c in range(4)] + [wj.zero()] * 4,
            8.192e-6, 'real', 'int16', 'sparse'),
        # test_synthesize_on_mesh_routes_stack
        'stack': (vstack_channels(4, n_pulses=100, seed=7), 8.192e-6,
                  'real', None, 'stack'),
        # the station schedule's shape at occupancy 1: the dense grid
        'dense': ([wj.gaussian(9e-6) * wj.cos(2 * np.pi * (90e6 + 5e6 * c))
                   for c in range(4)], 8.192e-6, 'real', None, 'dense'),
    }


@pytest.mark.parametrize('case', list(_routing_cases()))
def test_on_mesh_routing_parity(monkeypatch, case):
    chans, stop, part, dt, route = _routing_cases()[case]
    spy = Spy(monkeypatch)
    jdt = jnp.int16 if dt == 'int16' else jnp.float32
    tdt = torch.int16 if dt == 'int16' else None
    ref = np_of(mj.synthesize_on_mesh(chans, 0, stop, FS, mesh_j(),
                                      part=part, interpret=True,
                                      out_dtype=jdt))
    assert spy.take() == route
    chans_t = [waveform_from_jax(c) for c in chans]
    plane = parallel.synthesize_on_mesh(chans_t, 0, stop, FS, mesh_t(),
                                        part=part, out_dtype=tdt)
    assert spy.take() == route
    got = np_of(plane)
    if dt == 'int16':
        assert np.abs(got.astype(int) - ref).max() <= 1
    elif part == 'complex':
        assert rel(got.real, ref.real) <= TOL_JAX
        assert rel(got.imag, ref.imag) <= TOL_JAX
    else:
        assert rel(got, ref) <= TOL_JAX
        assert rel(got, oracle(chans, 0, stop, FS)) <= RTOL


def test_on_mesh_rows_per_tile_forces_dense(monkeypatch):
    spy = Spy(monkeypatch)
    chans = sparse_schedule(6, seed=12)
    mj.synthesize_on_mesh(chans, 0, 8.192e-6, FS, mesh_j(), rows_per_tile=8,
                          interpret=True)
    assert spy.take() == 'dense'
    chans_t = [waveform_from_jax(c) for c in chans]
    got = parallel.synthesize_on_mesh(chans_t, 0, 8.192e-6, FS, mesh_t(),
                                      rows_per_tile=8)
    assert spy.take() == 'dense'
    low = lower_schedule(chans_t, 0, 8.192e-6, FS)
    assert torch.equal(got.gather(),
                       synthesize_device(DeviceSchedule(low, 'cpu')))


def test_on_mesh_dac_scale_forwarded():
    """int16 through the mesh entry takes the caller's scale (the JAX
    suite's test_on_mesh_dac_scale_forwarded)."""
    chans = [waveform_from_jax(c) for c in sparse_schedule(4, seed=2)]
    f32 = np_of(parallel.synthesize_on_mesh(chans, 0, 8.192e-6, FS,
                                            mesh_t()))
    codes = np_of(parallel.synthesize_on_mesh(
        chans, 0, 8.192e-6, FS, mesh_t(), out_dtype=torch.int16,
        dac_scale=1000.0))
    assert codes.dtype == np.int16
    want = np.clip(np.round(f32.astype(np.float64) * 1000.0), -32768, 32767)
    assert np.abs(codes.astype(np.int64) - want.astype(np.int64)).max() <= 1


def test_station_synthesis_on_mesh():
    """The station schedule of tests/test_station_e2e.py through the mesh
    entry point: within 2e-6 of the oracle, and of JAX's mesh run within
    1e-6 of each channel's peak."""
    from test_station_e2e import SPAN, build_station_schedule
    chans = build_station_schedule()
    names = sorted(chans)
    t = np.arange(0, SPAN, 1 / FS)
    want = np.stack([np.asarray(
        (chans[n].simplify() if isinstance(chans[n], VStackJ)
         else chans[n])(t)).real for n in names])
    got = np_of(parallel.synthesize_on_mesh(
        [waveform_from_jax(chans[n]) for n in names], 0, SPAN, FS,
        mesh_t()))
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-6
    ref = np_of(mj.synthesize_on_mesh([chans[n] for n in names], 0, SPAN,
                                      FS, mesh_j(), interpret=True))
    assert np.abs(got - ref).max() / np.abs(ref).max() <= TOL_JAX
