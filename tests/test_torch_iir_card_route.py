"""The signal chain's route on the card, checked on the CPU.

On a CUDA tensor every real section of ``lfilter``, ``lfilter_zf``,
``sosfilt`` and ``filter_zpk`` runs the recurrence kernel S1; on a CPU
tensor each takes the JAX module's route (``ops.iir._route``).  The route
function is checked for both devices here, passed as ``torch.device``
(no card is needed to ask it).  The card route's arithmetic runs on CPU
tensors through S1's plain version, with ``_route`` patched to answer as
it does for the card, and is held:

- to scipy at the JAX suite's bounds (``test_torch_signal.CASES``, and
  2e-8 / 1e-9 of the peak for the zpk cases, as there);
- to JAX's own function (x64, on the CPU) within 1e-10 of the peak; the
  clustered (b, a) filter within the JAX suite's 1e-5 (JAX's ``lax.scan``
  is ~5e-7 off scipy there), and the Z-settle pair within that case's
  scipy bound 1e-7 (JAX's doubling scan is itself 4.6e-8 off scipy, and
  S1's plain version equals scipy's recurrence; 1e-6 from a non-zero
  state, where JAX is 5.8e-7 off);
- ``filter_zpk``'s d = 1 sections to its FIR + AR1 form (the CPU route)
  within 1e-12 of the peak.
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

import jax.numpy as jnp
from test_torch_signal import CASES, CLUSTERED, FS, TOL_JAX, _signal, rel
from waveforms_tpu.distortion import combine_filters, exp_decay_filter
from waveforms_tpu.ops import iir as jiir
from waveforms_tpu_torch.ops import iir as tiir
from waveforms_tpu_torch.ops.reference_iir import MAX_STATE

CPU = torch.device('cpu')
CARD = torch.device('cuda')
TOL_JAX_CARD = {'lfilter_clustered': 1e-5, 'lfilter_z_settle': 1e-7}
TOL_ZPK_FORMS = 1e-12

# (z, p, k) beside scipy's bound on sosfilt(zpk2sos(z, p, k))
ZPK = {
    'clustered': (*exp_decay_filter(*CLUSTERED, FS, output='zpk'), 2e-8),
    'more_zeros_than_poles': ([0.999, 0.99, 0.5], [0.9995, 0.98], 0.7,
                              1e-9),
    'more_poles_than_zeros': ([0.995], [0.9999, 0.99, 0.6], 0.3, 1e-9),
    'mixed_real_and_complex': (
        [0.999, 0.9 * np.exp(0.3j), 0.9 * np.exp(-0.3j)],
        [0.9995, 0.95 * np.exp(0.2j), 0.95 * np.exp(-0.2j), 0.5], 0.2,
        1e-9),
}


def _z_settle():
    return combine_filters([exp_decay_filter(a, t, FS, inv=True)
                            for a, t in zip([0.02, 0.005], [3e-6, 20e-6])])


def _a(b, a):
    return tiir._normalised(b, a)[1]


@pytest.fixture
def card_route(monkeypatch):
    """``_route`` answering as for a CUDA tensor, and the routes it gave."""
    real = tiir._route
    seen = []

    def route(device, *args, **kw):
        seen.append(real(CARD, *args, **kw))
        return seen[-1]
    monkeypatch.setattr(tiir, '_route', route)
    return seen


@pytest.fixture
def calls(monkeypatch):
    """Counts of the port's S1 calls and doubling scans."""
    seen = {'_sequential_filter': 0, '_doubling_df2t': 0,
            '_ar1_doubling': 0, 'complex': 0}
    for name in ('_sequential_filter', '_doubling_df2t', '_ar1_doubling'):
        real = getattr(tiir, name)

        def spy(*a, _real=real, _name=name, **kw):
            seen[_name] += 1
            if _name == '_ar1_doubling' and np.iscomplexobj(a[0]):
                seen['complex'] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(tiir, name, spy)
    return seen


@pytest.mark.parametrize('name', list(CASES))
def test_cpu_route_is_the_jax_probe(name, monkeypatch):
    """On CPU tensors the route function gives JAX's answer: each case
    takes S1 exactly as often as JAX takes its ``lax.scan``, and each
    lfilter section's route is JAX's ``_doubling_unstable`` probe."""
    call, n, _, _ = CASES[name]
    real = tiir._route
    asked = []

    def route(device, aa, m, form='lfilter'):
        asked.append((device, np.array(aa), m, form, real(device, aa, m,
                                                          form)))
        return asked[-1][-1]
    monkeypatch.setattr(tiir, '_route', route)
    jax_scans = []
    jax_seq = jiir._sequential_filter
    monkeypatch.setattr(jiir, '_sequential_filter',
                        lambda *a: jax_scans.append(1) or jax_seq(*a))
    x = _signal(n, seed=1)
    call(tiir, torch.tensor(x))
    call(jiir, jnp.asarray(x))
    assert all(dev.type == 'cpu' for dev, *_ in asked)
    assert asked or name == 'filter_zpk_complex_poles'   # no real root
    assert sum(r == 'S1' for *_, r in asked) == len(jax_scans)
    for _, aa, m, form, r in asked:
        if form == 'lfilter':
            assert (r == 'S1') == jiir._doubling_unstable(
                tiir._state_space(aa, aa, len(aa) - 1)[0], m)
        if form == 'zpk':
            assert r == 'doubling'


@pytest.mark.parametrize('form', ['lfilter', 'sos', 'zpk'])
def test_card_route_is_s1_for_every_real_section(form):
    """A CUDA device gives S1 for every section of 1 to 16 states at every
    length, where the CPU probe gives the doubling scan or S1; above 16
    states the card keeps the CPU's rule."""
    b5, a5 = sps.butter(5, 0.15)
    sections = {
        'lfilter': [_a(b5, a5), _a(*exp_decay_filter(*CLUSTERED, FS,
                                                     output='ba')),
                    _a(*_z_settle()), _a([1.0], [1.0, -0.5]),
                    _a([1.0], np.poly(np.full(MAX_STATE, 0.3)))],
        'sos': [sps.butter(4, 0.1, output='sos')[0, 3:],
                np.array([1.0, -2 * (1 - 1e-8), (1 - 1e-8) ** 2])],
        'zpk': [np.array([1.0, -p]) for p in (0.99998, 0.5, -0.3)],
    }[form]
    cpu_routes = set()
    for aa in sections:
        for n in (7, 4096, 65_536, 2_000_000):
            assert tiir._route(CARD, aa, n, form) == 'S1'
            assert tiir._route(torch.device('cuda', 0), aa, n, form) == 'S1'
            cpu_routes.add(tiir._route(CPU, aa, n, form))
    assert cpu_routes == ({'doubling'} if form == 'zpk'
                          else {'doubling', 'S1'})
    wide = _a([1.0], np.poly(np.full(MAX_STATE + 1, 0.3)))
    for n in (64, 2_000_000):
        assert tiir._route(CARD, wide, n) == tiir._route(CPU, wide, n)


def test_card_route_ignores_the_shards_length(card_route, calls):
    """On the card a 2,048-sample shard takes S1 in ``lfilter`` and
    ``lfilter_zf`` alike, with or without its row's length: the CPU's
    probe sends the clustered filter over 2,048 samples to the doubling
    scan (the test below)."""
    b, a = exp_decay_filter(*CLUSTERED, FS, output='ba')
    x = torch.tensor(_signal(2048, seed=2))
    tiir.lfilter(b, a, x, route_n=2_000_000)
    tiir.lfilter_zf(b, a, x, route_n=2_000_000)
    tiir.lfilter(b, a, x)
    assert card_route == ['S1'] * 3
    assert calls['_sequential_filter'] == 3 and not calls['_doubling_df2t']


def test_cpu_route_takes_the_rows_length(calls):
    """On CPU tensors ``route_n``, not the shard's length, decides."""
    b, a = exp_decay_filter(*CLUSTERED, FS, output='ba')
    aa = _a(b, a)
    assert tiir._route(CPU, aa, 2048) == 'doubling'
    assert tiir._route(CPU, aa, 2_000_000) == 'S1'
    x = torch.tensor(_signal(2048, seed=2))
    tiir.lfilter(b, a, x)
    assert calls == {'_sequential_filter': 0, '_doubling_df2t': 1,
                     '_ar1_doubling': 0, 'complex': 0}
    tiir.lfilter(b, a, x, route_n=2_000_000)
    tiir.lfilter_zf(b, a, x, route_n=2_000_000)
    assert calls['_sequential_filter'] == 2 and calls['_doubling_df2t'] == 1


@pytest.mark.parametrize('name', list(CASES))
def test_card_route_matches_scipy_and_jax(name, card_route, calls):
    """Every case of the signal suite through the card's route: S1 for
    every real section, the doubling scan for complex pairs alone."""
    call, n, tol_sp, tol_jax = CASES[name]
    x = _signal(n, seed=len(name))
    got = call(tiir, torch.tensor(x))
    got = (got[0] if isinstance(got, tuple) else got).numpy()
    want_jax = call(jiir, jnp.asarray(x))
    want_jax = np.asarray(want_jax[0] if isinstance(want_jax, tuple)
                          else want_jax)
    want_sp = call(sps, x)
    want_sp = want_sp[0] if isinstance(want_sp, tuple) else want_sp
    assert got.dtype == np.float64 and got.shape == x.shape
    assert rel(got, want_sp) <= tol_sp
    assert rel(got, want_jax) <= TOL_JAX_CARD.get(name, tol_jax)
    assert set(card_route) <= {'S1'}
    assert card_route or name == 'filter_zpk_complex_poles'
    assert calls['_sequential_filter'] == len(card_route)
    assert calls['_doubling_df2t'] == 0
    assert calls['_ar1_doubling'] == calls['complex']


@pytest.mark.parametrize('name', ['butter5', 'z_settle', 'clustered'])
def test_card_lfilter_with_state(name, card_route):
    """lfilter from a non-zero state, y and zf, against scipy and JAX."""
    b, a = {'butter5': sps.butter(5, 0.15), 'z_settle': _z_settle(),
            'clustered': exp_decay_filter(*CLUSTERED, FS,
                                          output='ba')}[name]
    d = max(len(a), len(b)) - 1
    x = _signal(20_000, seed=4)
    zi = sps.lfiltic(b, a, np.full(len(b) - 1, 0.3),
                     np.full(len(a) - 1, 0.2))[:d]
    y, zf = tiir.lfilter(b, a, torch.tensor(x), zi=zi)
    want, want_zf = sps.lfilter(b, a, x, zi=zi)
    np.testing.assert_array_equal(y.numpy(), want)
    np.testing.assert_array_equal(zf.numpy(), want_zf)
    yj, zfj = jiir.lfilter(b, a, jnp.asarray(x), zi=jnp.asarray(zi))
    # JAX's doubling scan of the Z-settle pair is itself 5.8e-7 off scipy
    # from this state, its clustered lax.scan ~1e-6
    tol = {'butter5': TOL_JAX, 'z_settle': 1e-6, 'clustered': 1e-5}[name]
    peak = np.abs(want).max()         # zf too, of the output's peak
    assert rel(y.numpy(), np.asarray(yj)) <= tol
    assert np.abs(zf.numpy() - np.asarray(zfj)).max() <= tol * peak


def test_card_lfilter_keeps_f32(card_route):
    """An f32 signal stays f32 on S1's route, within 1e-6 of the peak of
    scipy's f64 answer (JAX's doubling lfilter promotes it to f64)."""
    b, a = sps.butter(2, 0.3)
    x = _signal(8192, seed=6)
    y = tiir.lfilter(b, a, torch.tensor(x, dtype=torch.float32))
    assert y.dtype == torch.float32 and card_route == ['S1']
    assert rel(y.numpy(), sps.lfilter(b, a, x.astype(np.float32))) <= 1e-6


def test_card_sosfilt_carries_state_over_chunks(card_route, calls):
    """sosfilt over (rows, n) in four chunks with one zi per row and
    section: each section one S1 call a chunk; the chunks' output and zf
    equal the whole call's bit for bit (the sequential plain version), and
    hold to scipy's sosfilt (1e-9 of the peak, zf 1e-12 absolute) and to
    JAX's (1e-10)."""
    sos = sps.butter(4, 0.05, output='sos')
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 8000)).cumsum(-1) * 0.01
    zi = rng.standard_normal((3, sos.shape[0], 2)) * 0.1
    whole, zf_whole = tiir.sosfilt(sos, torch.tensor(x), zi=zi)
    assert calls['_sequential_filter'] == sos.shape[0]
    z = torch.tensor(zi)
    parts = []
    for k in range(4):
        y, z = tiir.sosfilt(sos, torch.tensor(x[:, k * 2000:(k + 1) * 2000]),
                            zi=z)
        parts.append(y)
    assert calls['_sequential_filter'] == 5 * sos.shape[0]
    assert not calls['_doubling_df2t'] and set(card_route) == {'S1'}
    got = torch.cat(parts, -1)
    assert torch.equal(got, whole) and torch.equal(z, zf_whole)
    assert tuple(z.shape) == (3, sos.shape[0], 2)
    for r in range(3):
        want, want_zf = sps.sosfilt(sos, x[r], zi=zi[r])
        assert rel(got[r].numpy(), want) <= 1e-9
        np.testing.assert_allclose(z[r].numpy(), want_zf, rtol=0,
                                   atol=1e-12)
        yj, zfj = jiir.sosfilt(jnp.asarray(sos), jnp.asarray(x[r]),
                               zi=jnp.asarray(zi[r]))
        assert rel(got[r].numpy(), np.asarray(yj)) <= TOL_JAX
        assert rel(z[r].numpy(), np.asarray(zfj)) <= TOL_JAX


@pytest.mark.parametrize('name', list(ZPK))
def test_card_filter_zpk(name, card_route, calls, monkeypatch):
    """filter_zpk on the card's route: one S1 call a real pole (its zero
    at the same index in the same section), the complex doubling scan for
    complex pairs alone; against scipy, JAX and its own FIR + AR1 form."""
    z, p, k, tol_sp = ZPK[name]
    x = _signal(20_000, seed=5)
    got = tiir.filter_zpk(z, p, k, torch.tensor(x)).numpy()
    n_real = sum(abs(np.imag(r)) <= 1e-12 for r in np.atleast_1d(p))
    n_cplx = len(np.atleast_1d(p)) - n_real
    assert calls['_sequential_filter'] == n_real == len(card_route)
    assert calls['_ar1_doubling'] == calls['complex'] == n_cplx
    assert got.dtype == np.float64 and got.shape == x.shape
    assert rel(got, sps.sosfilt(sps.zpk2sos(z, p, k), x)) <= tol_sp
    want = np.asarray(jiir.filter_zpk(z, p, k, jnp.asarray(x)))
    assert rel(got, want) <= TOL_JAX
    monkeypatch.undo()               # the CPU route: FIR + AR1 doubling
    fir_ar1 = tiir.filter_zpk(z, p, k, torch.tensor(x)).numpy()
    assert rel(got, fir_ar1) <= TOL_ZPK_FORMS


def test_card_filter_zpk_pairs_by_index(card_route, monkeypatch):
    """The real roots are sorted in descending order and paired by index,
    as JAX pairs them: section i is b = [1, -zr[i]], a = [1, -pr[i]], an
    unpaired pole b = [1, 0]; an unpaired zero stays a 1-tap FIR."""
    sections = []
    real = tiir._sequential_filter

    def spy(bb, aa, x, zi0, state_only=False):
        sections.append((list(bb), list(aa)))
        return real(bb, aa, x, zi0, state_only)
    monkeypatch.setattr(tiir, '_sequential_filter', spy)
    x = torch.tensor(_signal(1000, seed=9))
    tiir.filter_zpk([0.2, 0.9], [0.5, 0.99, 0.7], 1.0, x)
    assert sections == [([1.0, -0.9], [1.0, -0.99]),
                        ([1.0, -0.2], [1.0, -0.7]),
                        ([1.0, 0.0], [1.0, -0.5])]
    sections.clear()
    tiir.filter_zpk([0.3, 0.95, 0.6], [0.9], 1.0, x)
    assert sections == [([1.0, -0.95], [1.0, -0.9])]


@pytest.mark.parametrize('route', ['cpu', 'card'])
@pytest.mark.parametrize('name', ['butter5', 'z_settle', 'clustered'])
def test_lfilter_zf_takes_lfilters_route(name, route, monkeypatch):
    """lfilter_zf and lfilter agree on the route and the final state, bit
    for bit, from a zero state and from a given one, over a shard whose
    row is longer (``route_n``)."""
    b, a = {'butter5': sps.butter(5, 0.15), 'z_settle': _z_settle(),
            'clustered': exp_decay_filter(*CLUSTERED, FS,
                                          output='ba')}[name]
    real = tiir._route
    routes = []

    def spy(device, *args, **kw):
        routes.append(real(CARD if route == 'card' else device, *args,
                           **kw))
        return routes[-1]
    monkeypatch.setattr(tiir, '_route', spy)
    d = max(len(a), len(b)) - 1
    x = torch.tensor(np.random.default_rng(3).standard_normal((2, 3000)))
    zi = torch.tensor(np.random.default_rng(4).standard_normal((2, d)))
    for n in (None, 400_000):
        for z in (None, zi):
            zf = tiir.lfilter_zf(b, a, x, route_n=n, zi=z)
            _, want = tiir.lfilter(b, a, x, route_n=n,
                                   zi=torch.zeros(d, dtype=torch.float64)
                                   if z is None else z)
            assert routes[-1] == routes[-2]
            assert torch.equal(zf, want)
    if route == 'card':
        assert set(routes) == {'S1'}
