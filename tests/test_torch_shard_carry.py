"""The carry of a time-sharded IIR filter across its shards, in parallel
(``reference_iir.shard_carry``, ``ops.iir.shard_carry``), and the state-only
call of the recurrence kernel S1 (``kernels.iir_df2t`` with ``y`` None) in
its plain versions.

A row split into P time shards is filtered shard by shard from each shard's
start state, z_in[j] = Phi(n_{j-1}) z_in[j-1] + zf0[j-1], where zf0[j] is
shard j's end state from a zero state and Phi(n) the state map over n
samples.  The start states are held against scipy's ``lfilter`` carried
from shard to shard in ``np.longdouble``: no farther from it than twice the
same carry in float64 (scipy's own recurrence), or 1e-13 of the row's
largest state where that is larger -- the rule S1's blocked scan is held to
(``chip_smoke.py`` ``s1_contract``).  ``make_step``'s carry across
processes, run in one process with every time shard a run of its own, is
held by the same rule to its carry from shard to shard, and to scipy's
float64 filter of the whole row within the route's bound.  S1's state-only plain call writes the full call's
``zf`` bit for bit.
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from waveforms_tpu_torch import kernels, parallel
from waveforms_tpu_torch.distortion import combine_filters, exp_decay_filter
from waveforms_tpu_torch.ops import iir, iir_cases, reference_iir
from waveforms_tpu_torch.ops.lowering import lower_schedule
from waveforms_tpu_torch.parallel import pipeline
from waveforms_tpu_torch.ops.synth import DeviceSchedule, synthesize_device
from test_torch_mesh import FS, mesh_t, sparse_schedule
from waveforms_tpu_torch.convert import waveform_from_jax

Z_SETTLE = ([0.02, 0.005], [3e-6, 20e-6])
STOP = 8.192e-6
TOL_STEP = 1e-9


def _filters():
    f = dict(iir_cases.filters())
    f['z_settle'] = combine_filters([exp_decay_filter(a, t, FS, inv=True)
                                     for a, t in zip(*Z_SETTLE)])
    return f


def _states(b, a, x, lengths, dtype):
    """The start state of each shard, carried by scipy's lfilter in
    ``dtype``, and each shard's end state from zero in float64."""
    d = max(len(a), len(b)) - 1
    b = np.asarray(b, float)
    a = np.asarray(a, float)
    bb, aa = (np.asarray(v, dtype) for v in (b / a[0], a / a[0]))
    R = x.shape[0]
    start = np.zeros((R, len(lengths), d), dtype)
    zf0 = np.zeros((R, len(lengths), d))
    off = 0
    for r in range(R):
        z = np.zeros(d, dtype)
        off = 0
        for j, n in enumerate(lengths):
            start[r, j] = z
            seg = x[r, off:off + n]
            if n:
                z = sps.lfilter(bb, aa, seg.astype(dtype), zi=z)[1]
                zf0[r, j] = sps.lfilter(b, a, seg, zi=np.zeros(d))[1]
            off += n
    return start, zf0


def _check_carry(b, a, lengths, seed=0, rows=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, sum(lengths)))
    ld, zf0 = _states(b, a, x, lengths, np.longdouble)
    f64, _ = _states(b, a, x, lengths, np.float64)
    d = ld.shape[-1]
    got = iir.shard_carry(b, a, torch.from_numpy(zf0), lengths,
                          torch.zeros((rows, d), dtype=torch.float64))
    assert got.shape == (rows, len(lengths), d)
    assert got.dtype == torch.float64
    truth = ld.astype(float)
    scale = np.maximum(np.abs(truth).max(axis=(1, 2)), 1e-300)[:, None, None]
    err = (np.abs(got.numpy() - truth) / scale).max()
    seq = (np.abs(f64 - truth) / scale).max()
    assert err <= max(2 * seq, 1e-13), (err, seq)
    return err, seq


@pytest.mark.parametrize('d', range(1, 17))
def test_shard_carry_every_state_size(d):
    """d = 1 ... 16 (Butterworth filters), 4 shards of uneven lengths."""
    b, a = sps.butter(d, 0.3)
    _check_carry(b, a, [700, 1200, 513, 900], seed=d)


@pytest.mark.parametrize('name', ['clustered', 'z_settle'])
@pytest.mark.parametrize('n_shards', [2, 4, 8])
def test_shard_carry_clustered_and_z_settle(name, n_shards):
    b, a = _filters()[name]
    _check_carry(b, a, [1500 + 37 * j for j in range(n_shards)],
                 seed=n_shards)


def test_shard_carry_short_and_empty_shards():
    """Shards shorter than one of S1's chunks, an empty shard (Phi(0) is the
    identity and its end state zero), one of exactly a chunk."""
    b, a = _filters()['clustered']
    L = reference_iir.CHUNK
    _check_carry(b, a, [100, 0, L, L - 1, 3, 2 * L + 5, 0, 40])


def test_shard_carry_near_unit_pole_over_long_shards():
    """The near-unit double pole r = 1 - 1e-8 over shards of 40,000 to
    70,000 samples: Phi(n) over many groups of chunks."""
    b, a = _filters()['near_unit_double_pole']
    _check_carry(b, a, [40_000, 70_000, 55_555], rows=2)


def test_state_maps_compose_by_steps():
    """Phi(n) composed from chunks against the states n zero-input steps
    after each unit state, walked in double-double, compared as
    double-double pairs: equal within one chunk, within 1e-18 of the
    largest entry over a few chunks (Phi(CHUNK) products), and within 1e-12
    where Psi = Phi(CHUNK)^CARRY_GROUP enters.  The last is the clustered
    filter's: its eigenvalues are so close that a relative error of 1e-19
    in Psi (its 32 products) moves Psi's powers by ~1e-13, a property of
    the filter that S1's two-level carry shares (test_shard_carry_* hold
    the carry itself to the long-double answer)."""
    coef = iir_cases.coefficients(*_filters()['clustered'])
    L, M = reference_iir.CHUNK, reference_iir.CARRY_GROUP
    for n, tol in ((300, 0.0), (L, 0.0), (3 * L + 9, 1e-18),
                   (M * L + 3 * L + 9, 1e-12)):
        phi = reference_iir.state_maps(coef, [n])[n]
        walk = reference_iir._unit_walk(coef, n)
        diff = (phi[0] - walk[0].T) + (phi[1] - walk[1].T)
        assert diff.abs().max() <= tol * walk[0].abs().max(), n


def test_shard_carry_card_entry_equals_the_plain_one():
    """ops.iir.shard_carry (b, a on the host, the steps on the states'
    device) is the plain carry: on CPU tensors the same numbers."""
    b, a = _filters()['clustered']
    coef = iir_cases.coefficients(b, a)
    rng = np.random.default_rng(3)
    zf0 = torch.from_numpy(rng.standard_normal((2, 5, 3)) * 1e-3)
    zi = torch.from_numpy(rng.standard_normal((2, 3)) * 1e-3)
    lengths = [900, 0, 1700, 40, 512]
    assert torch.equal(iir.shard_carry(b, a, zf0, lengths, zi),
                       reference_iir.shard_carry(coef, zf0, lengths, zi))


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('n', [0, 7, 512, 3001])
def test_state_only_plain_call_writes_the_full_calls_zf(n, dtype):
    """S1's state-only call (y None) in its plain versions: the sequential
    df2t's zf and the blocked model's zf bit-equal to their full calls';
    through the wrapper on CPU tensors, no launch is counted."""
    b, a = _filters()['clustered']
    coef = iir_cases.coefficients(b, a, dtype)
    rng = np.random.default_rng(n)
    x = torch.tensor(rng.standard_normal((4, n)), dtype=dtype)
    zi = torch.tensor(rng.standard_normal((4, 3)) * 0.01, dtype=dtype)
    for fn in (reference_iir.df2t, reference_iir.df2t_blocked):
        y, zf, zs = torch.empty_like(x), torch.empty_like(zi), \
            torch.empty_like(zi)
        fn(x, coef, zi, y, zf)
        fn(x, coef, zi, None, zs)
        assert torch.equal(zf, zs), fn.__name__
    before = (kernels.iir_df2t.launches, kernels.iir_df2t.state_launches)
    zs = torch.empty_like(zi)
    assert kernels.iir_df2t(x, coef, zi, None, zs) is zs
    reference_iir.df2t(x, coef, zi, torch.empty_like(x), zf)
    assert torch.equal(zs, zf)
    assert (kernels.iir_df2t.launches,
            kernels.iir_df2t.state_launches) == before


@pytest.mark.parametrize('name', ['clustered', 'z_settle'])
def test_lfilter_zf_takes_lfilters_route(name, monkeypatch):
    """ops.iir.lfilter_zf: lfilter's final state from zero, by lfilter's
    route (S1's state-only call for the clustered filter, the doubling
    scan's own final state for the Z-settle pair), equal to lfilter's zf."""
    b, a = _filters()[name]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 4000)))
    calls = []
    orig = iir._sequential_filter

    def spy(*args, **kw):
        calls.append(kw.get('state_only', False))
        return orig(*args, **kw)

    monkeypatch.setattr(iir, '_sequential_filter', spy)
    zf = iir.lfilter_zf(b, a, x)
    want = iir.lfilter(b, a, x, zi=np.zeros(len(a) - 1))[1]
    assert torch.equal(zf, want)
    assert calls == ([True, False] if name == 'clustered' else [])


def _step_inputs():
    chans = [waveform_from_jax(c) for c in sparse_schedule(8, seed=4)]
    low = lower_schedule(chans, 0, STOP, FS)
    raw = synthesize_device(DeviceSchedule(low, 'cpu')).double().numpy()
    return low, raw


@pytest.mark.parametrize('name', ['clustered', 'z_settle'])
def test_lfilter_zf_from_a_start_state(name):
    """lfilter_zf from a start state, as a run of shards passes its final
    state along: equal to lfilter's zf from the same state."""
    b, a = _filters()[name]
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 4000)))
    zi = torch.from_numpy(rng.standard_normal((3, len(a) - 1)))
    assert torch.equal(iir.lfilter_zf(b, a, x, zi=zi),
                       iir.lfilter(b, a, x, zi=zi)[1])


@pytest.mark.parametrize('name', ['clustered', 'z_settle'])
@pytest.mark.parametrize('shape', [(4, 2), (2, 4), (1, 8)])
def test_make_step_parallel_carry_in_one_process(name, shape):
    """The step's carry across processes run in one process, every time
    shard a run of its own (``pipeline._make_step`` with
    ``pipeline._shard_runs``) on a mesh of CPU shards, 2, 4 and 8 time
    shards of 8,192 to 2,048 samples, every shard on its whole row's route
    (S1 for the clustered filter, the doubling scan for the Z-settle pair):
    no farther from scipy's lfilter in np.longdouble than twice
    ``make_step``'s carry from shard to shard (on CPU tensors scipy's own
    recurrence) or 1e-13, within the route's bound of scipy's float64
    lfilter (chip_smoke.py's: 1e-5 for the direct form, 2e-8 for the
    doubling scan), and the IQ points within 1e-6 of their peak of the
    shard-to-shard carry's."""
    low, raw = _step_inputs()
    ba = [_filters()[name]]
    mesh = mesh_t(*shape)
    rpt = {2: 8, 4: 4, 8: 2}[shape[1]]
    kw = dict(ba_filters=ba, demod_freqs=[50e6, -120e6], rows_per_tile=rpt)
    routes = []
    orig = iir._sequential_filter

    def spy(*args, **kw):
        routes.append(kw.get('state_only', False))
        return orig(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(iir, '_sequential_filter', spy)
        par, iq_p = pipeline._make_step(
            low, mesh, kw['ba_filters'], kw['demod_freqs'], rpt,
            pipeline._shard_runs)()
    seq, iq_s = parallel.make_step(low, mesh, **kw)()
    assert len({b.shape[1] for b in par.blocks[0]}) == 1
    # S1: a full call a shard, and a state-only call on every shard but a
    # row's last; doubling: none
    nc, nt = shape
    assert sorted(routes) == ([False] * mesh.size + [True] * nc * (nt - 1)
                              if name == 'clustered' else [])
    b, a = combine_filters(ba)
    want = sps.lfilter(b, a, raw)
    ld = np.stack([sps.lfilter(np.asarray(b, np.longdouble),
                               np.asarray(a, np.longdouble),
                               r.astype(np.longdouble)) for r in raw])
    peak = np.abs(want).max(axis=-1)

    def dist(x, y):
        return float((np.abs(x - y).max(axis=-1) / peak).max())

    got = par.gather().numpy()
    assert dist(got, ld.astype(float)) <= max(
        2 * dist(seq.gather().numpy(), ld.astype(float)), 1e-13)
    assert dist(got, want) <= {'clustered': 1e-5, 'z_settle': 2e-8}[name]
    assert (iq_p - iq_s).abs().max() <= 1e-6 * iq_s.abs().max()


def test_make_step_routes_each_shard_by_its_whole_row():
    """A time shard takes its whole row's route: the clustered filter on
    2,048-sample shards (where a row of 2,048 samples would take the
    doubling scan, 0.1 of the peak off scipy) runs S1, carried from shard
    to shard and across runs of one shard each."""
    low, raw = _step_inputs()
    ba = [_filters()['clustered']]
    b, a = combine_filters(ba)
    want = sps.lfilter(b, a, raw)
    peak = np.abs(want).max(axis=-1)
    M, _ = iir._state_space(*iir._normalised(b, a))
    assert not iir._doubling_unstable(M, 2048)
    assert iir._doubling_unstable(M, low.n_samples)
    for runs in (pipeline._runs, pipeline._shard_runs):
        plane, _ = pipeline._make_step(low, mesh_t(1, 8), ba, None, 2,
                                       runs)()
        assert [b.shape[1] for b in plane.blocks[0]] == [2048] * 8
        err = np.abs(plane.gather().numpy() - want).max(axis=-1) / peak
        assert err.max() <= 1e-5, runs


def test_one_process_step_carries_shard_to_shard():
    """On a mesh in one process a row is one run: make_step filters its
    shards one after another, each from the final state of the one before
    (the filter's own lfilter, bit for bit), with no state-only call."""
    low, raw = _step_inputs()
    ba = [_filters()['clustered']]
    b, a = combine_filters(ba)
    mesh = mesh_t(4, 2)
    routes = []
    orig = iir._sequential_filter

    def spy(*args, **kw):
        routes.append(kw.get('state_only', False))
        return orig(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(iir, '_sequential_filter', spy)
        plane, _ = parallel.make_step(low, mesh, ba_filters=ba,
                                      rows_per_tile=8)()
    assert routes == [False] * mesh.size
    zi0 = sps.lfiltic(b, a, np.zeros(len(a) - 1), np.zeros(len(b) - 1))
    raw_plane = parallel.synthesize_sharded(low, mesh, rows_per_tile=8)
    for row, got in zip(raw_plane.blocks, plane.blocks):
        z = torch.as_tensor(zi0).expand(row[0].shape[0], -1)
        for block, out in zip(row, got):
            want, z = iir.lfilter(b, a, block.double(), zi=z,
                                  route_n=low.n_samples)
            assert torch.equal(out, want)


def test_runs_group_a_rows_shards_by_owner():
    """A row's runs are its time shards grouped by owner in order; the
    step takes S1's state-only call on the shards of every run but the
    last; Mesh.spanning names owners only where they differ."""
    from waveforms_tpu_torch.parallel.mesh import Mesh
    assert pipeline._runs([0, 0, 1, 1, 0]) == [(0, [0, 1]), (1, [2, 3]),
                                               (0, [4])]
    assert pipeline._runs([1, 1]) == [(1, [0, 1])]
    assert pipeline._shard_runs([0, 0, 1]) == [(0, [0]), (0, [1]),
                                               (1, [2])]
    assert Mesh.spanning([[0, 0], [0, 0]]) is None
    assert Mesh.spanning([0, 1]).tolist() == [0, 1]
    owners = np.array([[0, 1]] * 4)
    mesh = Mesh(np.array([['cpu', None]] * 4, dtype=object), owners, 0)
    assert mesh.spans_processes and mesh.local == [(i, 0) for i in range(4)]
    assert mesh.plane_owners.tolist() == owners.tolist()
