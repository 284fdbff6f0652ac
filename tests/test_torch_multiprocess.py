"""The port's sharded step across OS processes, on ``torch.distributed``,
against the JAX package on its 8-device CPU mesh.

``python -m waveforms_tpu_torch.parallel.multiproc_smoke --device cpu
--backend gloo --layout jax time`` spawns 2 workers, each owning 4 CPU
shards of one (4, 2) ('channel', 'time') mesh, and runs the JAX package's
``tools/multiproc_smoke.py`` schedule through both layouts: JAX's (rank 0
owns channel shards 0-1 with both time shards) and the time split (rank r
owns time shard r, so that the filter's carry and the demodulation's sums
cross the processes).  Each worker checks itself (its blocks bit-equal to
the single-device call and to the port's mesh in one process, the rest at
JAX's bounds; the stacked-table kernel's two sharded paths bit for bit
against the same calls in one process) and writes its local blocks and
results to a ``.npz``; this
file holds them against the JAX package's sharded calls on the 8 virtual
CPU devices of tests/conftest.py in interpret mode (as
tests/test_torch_mesh.py does):

- ``synthesize_sharded``, ``synthesize_sparse_sharded`` and
  ``synthesize_on_mesh`` blocks within 1e-6 of each channel's peak of
  JAX's;
- the global mean within 1e-6 of the oracle's, the IQ points within
  JAX's rtol 2e-4, atol 1e-6 of the oracle's;
- ``fft_convolve_sharded`` within 1e-9 of numpy's circular convolution
  (JAX's smoke holds its f32 to 2e-3);
- ``make_step``'s filtered plane within 1e-9 of each row's peak of
  scipy's float64 ``lfilter`` of the whole row, and within 5e-5 of JAX's
  ``run_step`` where f32 holds the poles (the bounds of
  tests/test_torch_pipeline_sharded.py); on 8 time shards, S1's rule
  against scipy's long-double filter;
- the bytes each rank sent during the step at most the (C, d) boundary
  states plus the (C, n_tones) IQ points.

A worker that fails makes the run fail with its output.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.signal as sps

import waveforms_tpu as wj
import waveforms_tpu.ops.sparse_synth as sj
import waveforms_tpu.parallel.mesh as mj
import waveforms_tpu.parallel.pipeline as pj
from waveforms_tpu.ops.lowering import lower_schedule as lower_j
from waveforms_tpu_torch.distortion import combine_filters
from waveforms_tpu_torch.parallel import multiproc_smoke as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = ('jax', 'time')
STOP, FS = mp.STOP_SMALL, mp.FS


def _run(*args, timeout=300):
    res = subprocess.run(
        [sys.executable, '-m', 'waveforms_tpu_torch.parallel.multiproc_smoke',
         *args], cwd=REPO, capture_output=True, text=True, timeout=timeout)
    return res, res.stdout + res.stderr[-4000:]


@pytest.fixture(scope='module')
def smoke(tmp_path_factory):
    """Both layouts in one run of the two workers -> (their reports by
    (layout, rank), the npz of each)."""
    out = tmp_path_factory.mktemp('multiproc')
    res, text = _run('--device', 'cpu', '--backend', 'gloo', '--layout',
                     *LAYOUTS, '--out', str(out))
    assert res.returncode == 0, text
    assert res.stdout.strip().splitlines()[-1] == 'MULTIPROC OK', text
    reports = [json.loads(ln) for ln in res.stdout.splitlines()
               if ln.startswith('{')]
    assert sorted(r['rank'] for r in reports) == [0, 1], text
    by = {(lay['layout'], r['rank']): lay for r in reports
          for lay in r['layouts']}
    files = {k: dict(np.load(out / f'{k[0]}_rank{k[1]}.npz'))
             for k in by}
    return by, files


def _chans_j():
    """tools/multiproc_smoke.py's schedule, in the JAX package."""
    rng = np.random.default_rng(5)
    chans = []
    for c in range(8):
        x = wj.zero()
        if c % 2 == 0:
            I, _ = wj.mixing(0.5 * wj.cosPulse(50e-9) >> rng.uniform(0, 3e-6),
                             freq=-100e6 - 5e6 * c, DRAGScaling=1e-10)
            x += I
        else:
            x += 0.3 * (wj.square(200e-9, edge=20e-9)
                        >> rng.uniform(0, 3e-6))
        chans.append(x)
    return chans


@pytest.fixture(scope='module')
def jax_side():
    chans = _chans_j()
    mesh = mj.channel_mesh(n_channel=4, n_time=2)
    low = lower_j(chans, 0.0, STOP, FS)
    ba = mp.filters()['exp_decay'][0]
    step, _ = pj.run_step(chans, 0.0, STOP, FS, mesh, ba_filters=ba,
                          demod_freqs=mp.TONES, rows_per_tile=8,
                          interpret=True)
    t = np.arange(low.n_samples) / FS
    out = {
        'dense': np.asarray(mj.synthesize_sharded(low, mesh, rows_per_tile=8,
                                                  interpret=True)),
        'sparse': np.asarray(sj.synthesize_sparse_sharded(
            low, mesh, Rs=8, interpret=True)),
        'panel': np.asarray(mj.synthesize_on_mesh(chans, 0.0, STOP, FS,
                                                  mesh, interpret=True)),
        'step_exp_decay': np.asarray(step),
        'oracle': np.stack([w(t) for w in chans]),
    }
    # the port's router on CPU devices takes the JAX rule's route
    out['routed'] = out['panel']
    return out


def _blocks(files, layout, cell):
    """{(i, j): (block, (first row, first column))} over both ranks."""
    got = {}
    for (lay, _), f in files.items():
        if lay != layout:
            continue
        for key, v in f.items():
            parts = key.split('_')
            if key.startswith(cell + '_') and len(parts) == len(
                    cell.split('_')) + 2 and parts[-1].isdigit():
                i, j = int(parts[-2]), int(parts[-1])
                got[i, j] = (v, tuple(f[key + '_at']))
    return got


def _place(blocks, shape):
    whole = np.full(shape, np.nan)
    for blk, (r, c) in blocks.values():
        whole[r:r + blk.shape[0], c:c + blk.shape[1]] = blk
    return whole


@pytest.mark.parametrize('layout', LAYOUTS)
def test_workers_pass_their_checks(smoke, layout):
    """Each worker's own checks: blocks bit-equal to the single-device call
    and to the port's mesh in one process, the ranks' lowerings and layouts
    equal, the bounds of its docstring; its shards are those of the
    layout."""
    by, _ = smoke
    for rank in (0, 1):
        rec = by[layout, rank]
        assert rec['ok'], rec['failures']
        checks = {f"{c}.{k}": v for c, cell in rec['cells'].items()
                  for k, v in cell.get('checks', {}).items()}
        for name in ('dense.vs_single_device', 'dense.vs_one_process',
                     'sparse.vs_single_device', 'sparse.vs_one_process',
                     'panel.vs_one_process', 'routed.vs_one_process',
                     'layout.ranks_agree',
                     'step_clustered.vs_one_process', 'stack.vs_one_process',
                     'play_packed.vs_play_packed',
                     'gather.on_rank0' if rank == 0
                     else 'gather.none_elsewhere'):
            assert checks[name], name
        owners = np.array(rec['owners'])
        want = ([[0, 0], [0, 0], [1, 1], [1, 1]] if layout == 'jax'
                else [[0, 1]] * 4)
        assert owners.tolist() == want
        assert sorted(map(tuple, rec['local'])) == sorted(
            map(tuple, np.argwhere(owners == rank).tolist()))
    assert by[layout, 0]['cells']['layout']['digest'] == by[
        layout, 1]['cells']['layout']['digest']


@pytest.mark.parametrize('cell', ['dense', 'sparse', 'panel', 'routed'])
@pytest.mark.parametrize('layout', LAYOUTS)
def test_blocks_match_jax(smoke, jax_side, layout, cell):
    """Both ranks' blocks together cover the plane, within 1e-6 of each
    channel's peak of JAX's sharded result."""
    _, files = smoke
    want = jax_side[cell]
    got = _place(_blocks(files, layout, cell), want.shape)
    assert not np.isnan(got).any()
    peak = np.maximum(np.abs(want).max(axis=-1), 1e-30)
    assert (np.abs(got - want).max(axis=-1) <= 1e-6 * peak).all()


@pytest.mark.parametrize('layout', LAYOUTS)
def test_mean_iq_and_fft(smoke, jax_side, layout):
    """The global mean (a sum over both processes), the IQ points (the
    time shards' partial sums added over the processes) and the 8-shard
    FFT against the oracle and numpy, at JAX's bounds."""
    _, files = smoke
    oracle = jax_side['oracle']
    t = np.arange(oracle.shape[1]) / FS
    oracle_iq = oracle @ (np.exp(-2j * np.pi * np.outer(t, mp.TONES))
                          * (2.0 / len(t)))
    n_fft = 64 * 32
    x = np.sin(np.arange(n_fft) * 0.01)
    ker = np.exp(-0.5 * np.linspace(-3, 3, 21) ** 2)
    ker /= ker.sum()
    conv = np.fft.ifft(np.fft.fft(x) * np.fft.fft(ker, n=n_fft)).real
    shards = {}
    for rank in (0, 1):
        f = files[layout, rank]
        assert abs(float(f['mean']) - oracle.mean()) < 1e-6
        np.testing.assert_allclose(f['demod_iq'], oracle_iq, rtol=2e-4,
                                   atol=1e-6)
        shards.update({int(k[4:]): v for k, v in f.items()
                       if k.startswith('fft_')})
    assert sorted(shards) == list(range(8))
    got = np.concatenate([shards[p] for p in range(8)], -1)[0]
    assert np.abs(got - conv).max() <= 1e-9 * np.abs(conv).max()


@pytest.mark.parametrize('name', ['clustered', 'z_settle', 'exp_decay',
                                  'clustered_t8'])
@pytest.mark.parametrize('layout', LAYOUTS)
def test_step_matches_scipy_jax_and_sends_no_signal(smoke, jax_side, layout,
                                                    name):
    """make_step's filtered plane, its state carried across the time shards
    in parallel: within 1e-9 of each row's peak of scipy's float64 lfilter
    over the whole row; where f32 holds the poles, within 5e-5 of JAX's
    run_step; the bytes each rank sent during the step at most the (C, d)
    states plus the (C, n_tones) IQ points, which on the time split the
    boundary states fill; the IQ points equal on both ranks.
    ``clustered_t8``: the clustered filter on an 8-shard 'time' mesh over
    both processes, 4 shards of 1,024 samples each, rank 0's run of 4
    carried from shard to shard by state-only calls and the carry crossing
    once, is held by S1's rule: no
    farther from scipy's long-double filter than twice scipy's float64,
    and within the direct form's 1e-5 of scipy."""
    _, files = smoke
    cell = f'step_{name}'
    # the step's input: the port's K1 plane, as both ranks synthesized it
    raw = _place(_blocks(files, layout, 'dense'), jax_side['dense'].shape)
    b, a = combine_filters(mp.filters()[name.replace('_t8', '')][0])
    want = sps.lfilter(b, a, raw)
    got = _place(_blocks(files, layout, cell), want.shape)
    assert not np.isnan(got).any()
    peak = np.abs(want).max(axis=-1)
    err = np.abs(got - want).max(axis=-1) / peak
    if name.endswith('_t8'):
        # more time shards than a process holds, the carry crossing the
        # processes: S1's rule against the long double, and the direct
        # form's bound against scipy
        ld = np.stack([sps.lfilter(np.asarray(b, np.longdouble),
                                   np.asarray(a, np.longdouble),
                                   r.astype(np.longdouble)) for r in raw])
        ld = ld.astype(float)
        dist = (np.abs(got - ld).max(axis=-1) / peak).max()
        assert dist <= 2 * (np.abs(want - ld).max(axis=-1) / peak).max()
        assert err.max() <= 1e-5
    else:
        assert (err <= 1e-9).all()
    if name == 'exp_decay':
        ref = jax_side[cell]
        assert np.abs(got - ref).max() <= 5e-5 * np.abs(ref).max()
    d, C = len(a) - 1, raw.shape[0]
    bound = C * d * 8 + C * len(mp.TONES) * 8
    for rank in (0, 1):
        f = files[layout, rank]
        assert int(f[f'{cell}_bound']) == bound
        assert int(f[f'{cell}_sent']) <= bound
        assert int(f[f'{cell}_sent']) < raw[0].nbytes   # not one row
    if layout == 'time' or name.endswith('_t8'):
        # rank 0's (C, d) boundary states and the IQ points
        assert int(files[layout, 0][f'{cell}_sent']) == bound
    np.testing.assert_array_equal(files[layout, 0][f'{cell}_iq'],
                                  files[layout, 1][f'{cell}_iq'])


def test_a_failed_worker_fails_the_run():
    """Workers asked for the card on a host without one raise (nothing
    carries on on the CPU unasked), and the script exits 1 with their
    errors."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    res, text = _run('--device', 'cuda', '--backend', 'gloo', '--timeout',
                     '120', timeout=200)
    assert res.returncode == 1, text
    assert res.stdout.strip().splitlines()[-1] == 'MULTIPROC FAILED'
    reports = [json.loads(ln) for ln in res.stdout.splitlines()
               if ln.startswith('{')]
    assert len(reports) == 2 and not any(r['ok'] for r in reports)
    assert all(r['exitcode'] == 1 for r in reports)
