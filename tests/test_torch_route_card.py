"""The routers' two rules: the JAX package's on CPU devices, the H100's on
CUDA devices (``waveforms_tpu_torch.ops.routes``).

On every rung of the route ladder (``waveforms_tpu_torch.route_ladder``,
the port of ``tools/tpu_capture.py``'s occupancy ladder) at a small width,
each router -- ``classify_route``, ``classify_hi_route`` and
``synthesize_on_mesh`` -- gives on the CPU the kind that the JAX package's
router gives on the same lowering ('panel-windowed' read as 'panel'), and
under the card's rule the route that the ladder's record on the H100 found
(:data:`CARD_ROUTES`); the TPU's descriptor budget steers only the JAX
rule; every route the card's rule takes gives, through its plain version,
the plane of the JAX route within 1e-6 of the peak (int16 within one
code); and ``synthesize(..., device='cpu')`` routes as JAX.  The routers
are host code: no test needs a GPU.
"""

import dataclasses
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import waveforms_tpu as wj
import waveforms_tpu.ops.hi_synth as hj
import waveforms_tpu.ops.sparse_synth as sj
import waveforms_tpu.ops.stack_seq as ssj
import waveforms_tpu.parallel.mesh as mj
from waveforms_tpu.engine import classify_pallas_route
from waveforms_tpu.ops.lowering import lower_schedule as lower_j
import waveforms_tpu_torch as wt
from waveforms_tpu_torch import engine, route_ladder
from waveforms_tpu_torch.convert import lowered_from_jax
from waveforms_tpu_torch.ops import hi_synth, routes, sparse_synth, stack_seq
from waveforms_tpu_torch.ops.lowering import lower_schedule
from waveforms_tpu_torch.ops.stack_synth import build_stack_plan
from waveforms_tpu_torch.parallel import mesh as mt
from test_torch_engine import _route_cases

FS = 2e9
RUNGS = list(route_ladder.RUNGS)
# the width of the parity cases, and of the card-rule cases: the card's
# bands count the dense kernel's tiles over all channels, and at 8 channels
# a 1,048,576-sample rung is 1,024 tiles, in the band of the full-width
# rungs, as the 2-channel short windows and the flagship's first 16,384
# samples stay in the band below (the cuts are the full-width rungs'
# first channels, as on the card)
WIDTH = 4
CARD_WIDTH = 8
DTYPES_J = {'float32': jnp.float32, 'int16': jnp.int16,
            'bfloat16': jnp.bfloat16}
DTYPES_T = {'float32': torch.float32, 'int16': torch.int16,
            'bfloat16': torch.bfloat16}

# The card's route on each rung in f32, int16, pair mode (complex64) and
# the double tier (float64), from the route ladder's record on the H100
# (``python -m waveforms_tpu_torch.route_ladder``; NVIDIA H100 80GB HBM3,
# 700.00 W): on each rung the fastest route measured, or within
# route_ladder.ROUTE_SLACK of it, the stack kernel counted with its plan
# where the card's router would not build one otherwise.  bf16 stores as
# int16 does (a two-byte store), so its route is int16's.
CARD_ROUTES = {
    **{f'ladder{n}': ('dense', 'sparse', 'dense', 'dense')
       for n in (5, 10, 25)},
    **{f'ladder{n}': ('stack', 'stack', 'dense', 'dense')
       for n in (60, 120, 200, 300)},
    'mid': ('dense', 'sparse', 'dense', 'dense'),
    'flagship': ('sparse', 'sparse', 'sparse', 'dense'),
    'dense': ('dense', 'dense', 'dense', 'dense'),
    'station': ('dense', 'dense', 'dense', 'dense'),
    'flagship_16k': ('dense', 'dense', 'dense', 'dense'),
    'midband': ('dense', 'dense', 'dense', 'dense'),
}
CARD_KEYS = ('float32', 'int16', 'complex64', 'float64')


@lru_cache(maxsize=None)
def sources(width):
    keys = {key for key, _, _ in route_ladder.RUNGS.values()}
    builders = route_ladder.sources(width)
    return {k: builders[k]() for k in keys}


def rung(name, width):
    """(the port's channels, stop) of a rung at ``width`` channels."""
    key, stop, cut = route_ladder.RUNGS[name]
    return sources(width)[key][:cut], stop


def to_jax(chans):
    """The JAX package's waveforms equal to the port's, by the wire
    format."""
    return [wj.Waveform.fromlist(w.tolist()) for w in chans]


@lru_cache(maxsize=None)
def lowered(name, width, **kw):
    """(the JAX lowering, the port's copy of it) of a rung."""
    chans, stop = rung(name, width)
    low_j = lower_j(to_jax(chans), 0.0, stop, FS, **kw)
    return low_j, lowered_from_jax(low_j)


def jax_kind(kind):
    return {'panel-windowed': 'panel'}.get(kind, kind)


class _Picked(Exception):
    pass


def picker(monkeypatch, entries):
    """Replace each (module, name, kind) with a function that raises
    _Picked(kind) before any synthesis."""
    def pick(kind):
        def raise_(*a, **k):
            raise _Picked(kind)
        return raise_
    for mod, name, kind in entries:
        monkeypatch.setattr(mod, name, pick(kind))


def picked(call):
    with pytest.raises(_Picked) as got:
        call()
    return got.value.args[0]


@pytest.mark.parametrize('name', RUNGS)
def test_cpu_rule_is_jax_on_every_rung(name, monkeypatch):
    """classify_route (f32, int16, bf16 and pair mode) and
    classify_hi_route give the JAX routers' kinds, with no device and on a
    CPU device."""
    low_j, low_t = lowered(name, WIDTH)
    for dname, dt in DTYPES_J.items():
        want = jax_kind(classify_pallas_route(low_j, out_dtype=dt)[0])
        for device in (None, 'cpu'):
            kind, plan = engine.classify_route(
                low_t, out_dtype=DTYPES_T[dname], device=device)
            assert kind == want, (dname, device)
            assert (plan is None) == (kind == 'dense')
    low_j, low_t = lowered(name, WIDTH, part='complex')
    want = jax_kind(classify_pallas_route(low_j)[0])
    assert engine.classify_route(low_t, device='cpu')[0] == want
    low_j, low_t = lowered(name, WIDTH, keep_f64=True)
    picker(monkeypatch, ((hj, 'synthesize_hi', 'dense'),
                         (hj, 'synthesize_hi_panels', 'panel')))
    want = picked(lambda: hj.synthesize_hi_routed(low_j))
    assert hi_synth.classify_hi_route(low_t)[0] == want
    assert hi_synth.classify_hi_route(low_t, 'cpu')[0] == want


@pytest.mark.parametrize('name', RUNGS)
def test_mesh_rule_on_every_rung(name, monkeypatch):
    """synthesize_on_mesh takes JAX's sharded entry point on a mesh of CPU
    devices, and the card's route on a mesh of CUDA devices (the mesh's
    device type picks the rule; nothing is launched: each entry point is
    replaced by one that raises)."""
    picker(monkeypatch, (
        (sj, 'synthesize_panels_sharded', 'panel'),
        (sj, 'synthesize_sparse_sharded', 'sparse'),
        (ssj, 'synthesize_stack_sharded', 'stack'),
        (mj, 'synthesize_sharded', 'dense'),
        (sparse_synth, 'synthesize_panels_sharded', 'panel'),
        (sparse_synth, 'synthesize_sparse_sharded', 'sparse'),
        (stack_seq, 'synthesize_stack_sharded', 'stack'),
        (mt, 'synthesize_sharded', 'dense')))
    chans, stop = rung(name, WIDTH)
    want = picked(lambda: mj.synthesize_on_mesh(
        to_jax(chans), 0.0, stop, FS,
        mj.channel_mesh(2, 2, devices=jax.devices()[:4]), interpret=True))
    cpu = mt.channel_mesh(2, 2, devices=['cpu'] * 4)
    assert picked(lambda: mt.synthesize_on_mesh(
        chans, 0.0, stop, FS, cpu)) == want
    chans, stop = rung(name, CARD_WIDTH)
    card = mt.Mesh(np.array([[torch.device('cuda')] * 2] * 2,
                            dtype=object))
    assert picked(lambda: mt.synthesize_on_mesh(
        chans, 0.0, stop, FS, card)) == CARD_ROUTES[name][0]


@lru_cache(maxsize=None)
def card_lowered(name, **kw):
    chans, stop = rung(name, CARD_WIDTH)
    return lower_schedule(chans, 0.0, stop, FS, **kw)


def hi_lowered(name):
    """A rung's ``keep_f64`` lowering for the routers' double tier, at the
    parity width: the card's double-tier rule does not read a schedule's
    size (``panel_occ`` 0: K3 throughout)."""
    return lowered(name, WIDTH, keep_f64=True)[1]


@lru_cache(maxsize=None)
def card_plan(name):
    """The stack plan of a rung's card-width lowering (O(instances): the
    routers' calls below share it)."""
    return build_stack_plan(card_lowered(name))


def card_routes(name, low, low_pair, low_hi, device='cuda'):
    """The routers' kinds on a rung's lowerings -> CARD_KEYS order, and
    bf16's."""
    with route_ladder.planned(low, card_plan(name)):
        kinds = [engine.classify_route(low, out_dtype=DTYPES_T[d],
                                       device=device)[0]
                 for d in ('float32', 'int16', 'bfloat16')]
    bf16 = kinds.pop()
    kinds += [engine.classify_route(low_pair, device=device)[0],
              hi_synth.classify_hi_route(low_hi, device)[0]]
    return tuple(kinds), bf16


@pytest.mark.parametrize('name', RUNGS)
def test_card_rule_on_every_rung(name):
    """Under the card's rule (a CUDA device) each router takes the route
    that the ladder's record on the H100 found for the rung, in f32, int16,
    bf16, pair mode and the double tier."""
    kinds, bf16 = card_routes(name, card_lowered(name),
                              card_lowered(name, part='complex'),
                              hi_lowered(name))
    assert kinds == CARD_ROUTES[name]
    assert bf16 == CARD_ROUTES[name][1]
    assert routes.rule_for(torch.device('cuda', 0)) is routes.CARD_RULE


@pytest.mark.parametrize('name', RUNGS)
def test_budget_steers_only_the_jax_rule(name):
    """A schedule over the TPU's descriptor budget (``pallas_ok`` false)
    routes on the card as one within it; the JAX rule sends it past the
    panel, worklist and stack-first steps."""
    lows = [card_lowered(name), card_lowered(name, part='complex'),
            hi_lowered(name)]
    over = [dataclasses.replace(low, pallas_ok=False) for low in lows]
    assert card_routes(name, *over) == card_routes(name, *lows)
    jax_kinds = card_routes(name, *over, device='cpu')[0]
    assert jax_kinds[3] == 'dense'
    assert jax_kinds[0] in ('stack', 'dense')


# each route's forced engine (in the double tier K3's and K4's entry
# points: no engine forces K4)
FORCED = {'dense': 'cuda-dense', 'panel': 'cuda-panel',
          'sparse': 'cuda-sparse', 'stack': 'cuda-stack'}


@lru_cache(maxsize=None)
def plane(key, stop, route, **kw):
    """A rung's first channel (both of the 2-channel ones) through
    ``route`` on the CPU (the plain versions), None for the JAX rule's
    route (``synthesize(device='cpu')``); cached, rungs cut from one
    schedule sharing it."""
    chans = sources(1)[key]
    if route is None:
        return wt.synthesize(chans, 0.0, stop, FS, device='cpu', **kw)
    if kw.get('precision') == 'double':
        low = lower_schedule(chans, 0.0, stop, FS, keep_f64=True)
        return (hi_synth.synthesize_hi(low, device='cpu') if route == 'dense'
                else hi_synth.synthesize_hi_panels(low, device='cpu'))
    return wt.synthesize(chans, 0.0, stop, FS, engine=FORCED[route],
                         device='cpu', **kw)


@lru_cache(maxsize=None)
def jax_route(key, stop, **kw):
    """The JAX rule's route for ``plane``'s channels."""
    chans = sources(1)[key]
    if kw.get('precision') == 'double':
        low = lower_schedule(chans, 0.0, stop, FS, keep_f64=True)
        return hi_synth.classify_hi_route(low)[0]
    low = lower_schedule(chans, 0.0, stop, FS, part=kw.get('part', 'real'))
    return engine.classify_route(low, out_dtype=kw.get('out_dtype'))[0]


@pytest.mark.parametrize('name', RUNGS)
def test_card_routes_give_the_jax_routes_plane(name):
    """Each route the card's rule takes for a rung gives, through the
    kernels' plain versions on the CPU, the plane of the route the JAX rule
    takes (``device='cpu'``), where the two differ: within 1e-6 of each
    channel's peak in f32 and pair mode, one code in int16, 1e-12 in the
    double tier."""
    key, stop, _ = route_ladder.RUNGS[name]
    for dname, kw, tol in (('float32', {}, 1e-6),
                           ('int16', {'out_dtype': torch.int16}, 1),
                           ('complex64', {'part': 'complex'}, 1e-6),
                           ('float64', {'precision': 'double'}, 1e-12)):
        kind = CARD_ROUTES[name][CARD_KEYS.index(dname)]
        if kind == jax_route(key, stop, **kw):
            continue
        got = plane(key, stop, kind, **kw)
        want = plane(key, stop, None, **kw)
        err = (route_ladder.code_err if dname == 'int16'
               else route_ladder.rel_err)
        assert err(got, want) <= tol, dname


@pytest.mark.parametrize('name, jax_route', [('flagship', 'panel'),
                                             ('midband', 'stack')])
def test_synthesize_on_cpu_routes_as_jax(name, jax_route, monkeypatch):
    """``synthesize(..., device='cpu')`` passes its device to the routers:
    on two rungs where the card's route is another, it runs JAX's, in f32
    and in the double tier (each route's entry point, in both packages,
    replaced by one that raises)."""
    picker(monkeypatch, ((engine, 'synthesize_panels', 'panel'),
                         (engine, 'synthesize_sparse', 'sparse'),
                         (engine, 'synthesize_stack', 'stack'),
                         (engine, 'synthesize_device', 'dense'),
                         (hi_synth, 'synthesize_hi', 'dense'),
                         (hi_synth, 'synthesize_hi_panels', 'panel'),
                         (hj, 'synthesize_hi', 'dense'),
                         (hj, 'synthesize_hi_panels', 'panel')))
    chans, stop = rung(name, WIDTH)
    low_j, _ = lowered(name, WIDTH)
    assert jax_kind(classify_pallas_route(low_j)[0]) == jax_route
    assert CARD_ROUTES[name][0] != jax_route
    assert picked(lambda: wt.synthesize(chans, 0.0, stop, FS,
                                        device='cpu')) == jax_route
    low_j, _ = lowered(name, WIDTH, keep_f64=True)
    assert picked(lambda: wt.synthesize(
        chans, 0.0, stop, FS, device='cpu', precision='double')) == picked(
        lambda: hj.synthesize_hi_routed(low_j))


def test_rule_for_devices():
    assert routes.rule_for(None) is routes.JAX_RULE
    assert routes.rule_for('cpu') is routes.JAX_RULE
    assert routes.rule_for(torch.device('cpu')) is routes.JAX_RULE
    assert routes.rule_for('cuda') is routes.CARD_RULE
    assert routes.rule_for('cuda:1') is routes.CARD_RULE


def test_ladder_rung_on_the_cpu():
    """The ladder's own rung measurement on the CPU (the plain versions, no
    times): every route's plane agrees and the oracle holds, and its record
    names each rule's route as the routers give it."""
    chans, stop = rung('station', 2)
    rec = route_ladder.measure_rung('station', chans, stop, 'cpu')
    assert rec['ok'] and 'ms' not in rec['float32']
    low = lower_schedule(chans, 0.0, stop, FS)
    for dname in ('float32', 'int16'):
        for rule, device in (('jax', None), ('card', 'cuda')):
            assert rec[dname]['route'][rule] == engine.classify_route(
                low, out_dtype=DTYPES_T[dname], device=device)[0]
    assert rec['float32']['route'] == {'jax': 'panel', 'card': 'dense'}
    assert set(rec['float32']) >= {'vs_others', 'vs_oracle'}


def test_midband_rung_is_the_suites_midband():
    """The ladder's ``midband`` rung is the stack route's mid-band schedule
    of the JAX suite (test_torch_engine's ``midband_stack`` case)."""
    from test_torch_lowering import assert_lowered_equal
    chans_j, start, stop, fs = _route_cases()['midband_stack'][0]()
    chans, stop_t = rung('midband', 2)
    assert (start, stop, fs) == (0.0, stop_t, FS)
    assert_lowered_equal(lowered_from_jax(lower_j(chans_j, start, stop, fs)),
                         lower_schedule(chans, 0.0, stop, FS))
