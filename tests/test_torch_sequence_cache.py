"""``run_sequence``'s shot programs kept on the Sequencer, on the CPU.

A Sequencer keeps one shot program a key -- the shot count, the filters'
coefficients by value, the tones, ``rows_per_tile`` and the post-filter
builder in force -- for ``PROGRAMS_KEPT`` keys, the least recently used
out first; on the CPU the program is the shot body (the filter's closure
and the demodulation matrix), on the card its captured graph
(``tests/test_torch_cuda.py``).  Held here: a hit for the same key, a
miss for each part of it, results bit-equal to the plain host loop
``run_sequence_loop`` (which keeps nothing) over successive calls, a
returned tensor left alone by later calls, the bound, the programs gone
with their Sequencer, and threads that share one Sequencer.
"""

import gc
import sys
import threading
import time
import weakref

import pytest
import torch

import waveforms_tpu_torch as wt
from waveforms_tpu_torch.distortion import exp_decay_filter
from waveforms_tpu_torch.ops import Sequencer
from waveforms_tpu_torch.ops.lowering import lower_schedule
from waveforms_tpu_torch.parallel import pipeline, run_sequence, \
    run_sequence_loop
from waveforms_tpu_torch.utils import profiling

FS = 2e9
TONES = [-121.64e6, -67.52e6]
ORDERS = [[2, 0, 1, 1, 0, 2, 9], [0, 0, 2, 1, -1, 1, 2],
          [1, 2, 0, 0, 2, 1, 0]]


def _station_schedules():
    """The station shapes of ``test_torch_streaming._station_tables``,
    lowered by the port: 3 schedules of 2 channels (an XY pulse train and
    a Z square), 4,096 samples."""
    out = []
    for k in range(3):
        xy = wt.zero()
        for g in range(3):
            i, _ = wt.mixing(0.5 * wt.cosPulse(30e-9)
                             >> (0.2e-6 + g * 0.6e-6 + 0.05e-6 * k),
                             freq=-150e6, phase=0.7 * k, DRAGScaling=1e-10)
            xy += i
        z = 0.3 * (wt.square(80e-9, edge=10e-9) >> (0.5e-6 + 0.8e-6 * k))
        out.append(lower_schedule([xy, z], 0, 2.048e-6, FS))
    return out


def _filters(x=0.02):
    return [exp_decay_filter(a, t, FS, inv=True)
            for a, t in ((x, 3e-6), (0.005, 20e-6))]


def _seq():
    return Sequencer(_station_schedules(), device='cpu')


def _kw():
    return {'ba_filters': _filters(), 'demod_freqs': list(TONES)}


def _counts(seq):
    return seq.graph_hits, seq.graph_misses


@pytest.mark.parametrize('chain', ['signals', 'filtered', 'iq'])
def test_successive_calls_reuse_the_program_and_equal_the_loop(chain):
    """Three calls with other indices, the same key given in new lists:
    one miss, then hits; each result bit-equal to the plain loop's, and
    the first call's tensor unchanged after the later calls."""
    seq = _seq()

    def kw():
        return {'signals': {}, 'filtered': {'ba_filters': _filters()},
                'iq': _kw()}[chain]
    got = [run_sequence(seq, order, **kw()) for order in ORDERS]
    assert _counts(seq) == (2, 1)
    first = got[0].clone()
    for order, out in zip(ORDERS, got):
        want = run_sequence_loop(seq, order, **kw())
        assert out.dtype == want.dtype and torch.equal(out, want)
    assert torch.equal(got[0], first)
    assert _counts(seq) == (2, 1)           # the plain loop keeps nothing
    assert len({out.data_ptr() for out in got}) == len(got)


def _vary(part):
    """The base call's arguments with one part of the key changed."""
    kw = _kw()
    order = list(ORDERS[0])
    if part == 'filters':
        kw['ba_filters'] = _filters(0.021)
    elif part == 'tones':
        kw['demod_freqs'] = [TONES[0], TONES[1] + 1.0]
    elif part == 'n_shots':
        order = order[:-1]
    elif part == 'rows_per_tile':
        kw['rows_per_tile'] = 8
    return order, kw


@pytest.mark.parametrize('part', ['filters', 'tones', 'n_shots',
                                  'rows_per_tile', 'postfilter'])
def test_each_part_of_the_key_makes_a_miss(monkeypatch, part):
    """The base call, then the call with one part of its key changed (a
    miss, equal to the plain loop), then the base call again (a hit: its
    program is still kept)."""
    seq = _seq()
    run_sequence(seq, ORDERS[0], **_kw())
    order, kw = _vary(part)
    if part == 'postfilter':
        made = pipeline._make_postfilter

        def builder(*args):
            return made(*args)
        monkeypatch.setattr(pipeline, '_make_postfilter', builder)
    got = run_sequence(seq, order, **kw)
    assert _counts(seq) == (0, 2)
    assert torch.equal(got, run_sequence_loop(seq, order, **kw))
    monkeypatch.undo()
    run_sequence(seq, ORDERS[1], **_kw())
    assert _counts(seq) == (1, 2)


def test_a_hit_records_its_reuse_and_no_constants():
    """Under a profiler a miss makes its constants in
    ``wf.sequence.constants``; a hit opens one ``wf.sequence.reuse`` and
    makes none."""
    seq = _seq()
    names = []
    for order in ORDERS[:2]:
        t0 = time.perf_counter()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            run_sequence(seq, order, **_kw())
        rec = profiling.span_record()
        names.append([n for n, s in zip(rec.names, rec.starts)
                      if s >= t0 and n.startswith('wf.sequence.')])
    assert names == [['wf.sequence.constants'], ['wf.sequence.reuse']]


def test_the_sequencer_keeps_a_bounded_number_least_recently_used_out():
    """PROGRAMS_KEPT + 2 keys (shot counts 1, 2, ...), the first used
    again once the Sequencer holds PROGRAMS_KEPT: the two least recently
    used go (shot counts 2 and 3), the first stays."""
    seq = _seq()
    n = pipeline.PROGRAMS_KEPT + 2
    for shots in range(1, n + 1):
        run_sequence(seq, ORDERS[0][:shots])
        if shots == pipeline.PROGRAMS_KEPT:
            run_sequence(seq, ORDERS[1][:1])        # the first, again
    assert len(seq._shot_programs) == pipeline.PROGRAMS_KEPT
    assert _counts(seq) == (1, n)
    run_sequence(seq, ORDERS[2][:1])                # kept: a hit
    assert _counts(seq) == (2, n)
    run_sequence(seq, ORDERS[2][:2])                # gone: a miss
    assert _counts(seq) == (2, n + 1)
    assert len(seq._shot_programs) == pipeline.PROGRAMS_KEPT


def test_the_kept_programs_go_with_their_sequencer():
    """The kept shot body holds its Sequencer weakly: dropping the last
    reference to the Sequencer frees it and its programs."""
    seq = _seq()
    run_sequence(seq, ORDERS[0], **_kw())
    program = next(iter(seq._shot_programs.values()))
    refs = weakref.ref(seq), weakref.ref(program)
    del seq, program
    gc.collect()
    assert refs[0]() is None and refs[1]() is None


def test_threads_that_share_a_sequencer_take_turns(monkeypatch):
    """Sixteen threads on one Sequencer, PROGRAMS_KEPT + 2 keys (tones),
    with a short switch interval and a stand-in shot body (``[k, tone]``,
    built slowly): every lookup counted once, one build a miss, the bound
    held, and every result its own call's."""
    built = []

    def body(seq, ba_filters, demod_freqs, rows_per_tile):
        built.append(demod_freqs)
        time.sleep(1e-3)                # a window for a lost update
        return lambda k: torch.tensor([float(k), demod_freqs[0]])
    monkeypatch.setattr(pipeline, '_shot_body', body)
    seq = _seq()
    tones = [[float(t)] for t in range(pipeline.PROGRAMS_KEPT + 2)]
    errors = []

    def work(t):
        try:
            for c in range(20):
                order, tone = ORDERS[(t + c) % 3], tones[(t * c) % len(tones)]
                got = run_sequence(seq, order, demod_freqs=tone)
                want = torch.tensor([[float(k), tone[0]] for k in order])
                if not torch.equal(got, want):
                    errors.append((t, c))
        except Exception as e:          # reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert sum(_counts(seq)) == 16 * 20 and seq.graph_misses == len(built)
    assert len(seq._shot_programs) == pipeline.PROGRAMS_KEPT
