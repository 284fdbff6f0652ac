"""The port's profiling hooks (``waveforms_tpu_torch.utils.profiling``) on
the CPU: a trace with its annotation, the reader of the card's events on a
Kineto trace of the card's own shape, and no host clock in place of the
card's.  The card's case is ``tests/test_torch_cuda_fuzz.py``'s
``test_measure_device_times_k1``.
"""

import gzip
import json
import os
import statistics
import time

import pytest
import torch

import waveforms_tpu_torch as wt
from waveforms_tpu_torch import utils
from waveforms_tpu_torch.utils import profiling

K1 = ('void wfsynth::synth_dense_kernel<false, 4, false>(wfsynth::Desc, '
      'long long, long long, long long, int, int, void*, int, float const*)')
K3 = ('void wfsynth::synth_dense_hi_kernel<false>(wfsynth::DescHi, int, '
      'int, void*, float*, int)')
SPIN = 'void at::cuda::(anonymous namespace)::spin_kernel(long)'
MUL = ('void at::native::vectorized_elementwise_kernel<4, '
       'at::native::AUnaryFunctor<float, float, float, '
       'at::native::binary_internal::MulFunctor<float> >, '
       'std::array<char*, 2ul> >(int, ...)')


def kineto_trace(host_pid=4242):
    """A trace as Kineto writes one on an H100 host: the host's process
    labelled CPU, each GPU's labelled ``GPU <i>``, kernels, copies and an
    annotation on GPU 0's timeline, operators and runtime calls -- one of
    them named like the dense kernel -- on the host's."""
    meta = [{'name': 'process_name', 'ph': 'M', 'pid': host_pid, 'tid': 0,
             'args': {'name': 'python'}},
            {'name': 'process_labels', 'ph': 'M', 'pid': host_pid, 'tid': 0,
             'args': {'labels': 'CPU'}}]
    for gpu in range(2):
        meta += [{'name': 'process_name', 'ph': 'M', 'pid': gpu, 'tid': 0,
                  'args': {'name': 'python'}},
                 {'name': 'process_labels', 'ph': 'M', 'pid': gpu, 'tid': 0,
                  'args': {'labels': f'GPU {gpu}'}}]

    def x(name, cat, pid, ts, dur):
        return {'ph': 'X', 'cat': cat, 'name': name, 'pid': pid, 'tid': 7,
                'ts': ts, 'dur': dur, 'args': {}}
    events = [
        x(K1, 'kernel', 0, 300.0, 1358.5),
        x(K3, 'kernel', 0, 2000.0, 3253.0),
        x(K1, 'kernel', 0, 100.0, 1357.5),
        x(MUL, 'kernel', 0, 6000.0, 4.5),
        x('Memcpy HtoD (Pageable -> Device)', 'gpu_memcpy', 0, 50.0, 0.9),
        x('Memset (Device)', 'gpu_memset', 0, 60.0, 0.7),
        x('synth_dense_kernel_region', 'gpu_user_annotation', 0, 90.0, 9e3),
        x('synth_dense_kernel', 'cpu_op', host_pid, 80.0, 30.0),
        x('cudaLaunchKernel', 'cuda_runtime', host_pid, 85.0, 5.0),
        x(K1, 'kernel', host_pid, 95.0, 99.0),
        x(SPIN, 'kernel', 0, 10.0, 1.2),
    ]
    return {'schemaVersion': 1, 'traceEvents': meta + events}


def write(tmp_path, trace, name='host_4242.1.pt.trace.json', gz=False):
    path = tmp_path / (name + ('.gz' if gz else ''))
    opener = gzip.open if gz else open
    with opener(path, 'wt') as f:
        json.dump(trace, f)


def test_exports():
    """The JAX module's four names, in ``utils.profiling`` as in the JAX
    package (``utils.__all__`` stays the JAX package's)."""
    assert {'trace', 'annotate', 'device_event_times',
            'measure_device'} <= set(profiling.__all__)
    assert utils.profiling is profiling


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    chans = [wt.gaussian(1e-7) >> 2e-7]
    with profiling.trace(str(tmp_path)):
        with profiling.annotate('station_shot'):
            wt.synthesize(chans, 0.0, 1e-6, 2e9, device='cpu')
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith('.pt.trace.json')
    with open(tmp_path / files[0]) as f:
        events = json.load(f)['traceEvents']
    spans = [e for e in events if e.get('name') == 'station_shot']
    assert spans and spans[0]['ph'] == 'X'
    assert spans[0]['cat'] == 'user_annotation'


@pytest.mark.parametrize('gz', [False, True])
def test_device_event_times_keeps_the_cards_kernels(tmp_path, gz):
    """Only kernel events on a GPU's timeline whose names start with the
    prefix, without return type and namespaces, in seconds: not the host's
    operator of the same name, not the annotation over the kernels, not
    K3 for K1's prefix, not the copies, not the trace's lead (the spin
    kernel)."""
    write(tmp_path, kineto_trace(), gz=gz)
    assert profiling.device_event_times(
        str(tmp_path), 'synth_dense_kernel') == [1357.5e-6, 1358.5e-6]
    assert profiling.device_event_times(
        str(tmp_path), 'synth_dense_hi') == [3253.0e-6]
    assert len(profiling.device_event_times(str(tmp_path), 'synth_')) == 3
    assert profiling.device_event_times(str(tmp_path), 'Memcpy') == []
    assert profiling.device_event_times(str(tmp_path), 'cudaLaunch') == []
    assert profiling.device_event_times(str(tmp_path), 'spin') == []
    copies = profiling.device_events(str(tmp_path), profiling.COPIES)
    assert [e['cat'] for e in copies] == ['gpu_memcpy', 'gpu_memset']
    ts = [e['ts'] for e in profiling.device_events(str(tmp_path))]
    assert ts == sorted(ts) and len(ts) == 4


def test_device_event_times_reads_every_trace_under_the_directory(tmp_path):
    write(tmp_path, kineto_trace(), name='a.1.pt.trace.json')
    write(tmp_path, kineto_trace(host_pid=77), name='b.2.pt.trace.json')
    (tmp_path / 'notes.json').write_text('{}')
    assert len(profiling.device_event_times(str(tmp_path),
                                            'synth_dense_kernel')) == 4


def test_a_trace_with_no_card_has_no_device_events(tmp_path):
    trace = kineto_trace()
    trace['traceEvents'] = [e for e in trace['traceEvents']
                            if e.get('pid') not in (0, 1)]
    write(tmp_path, trace)
    assert profiling.device_event_times(str(tmp_path), '') == []


@pytest.mark.parametrize('name, head', [
    (K1, 'synth_dense_kernel<false, 4, false>(wfsynth::Desc'),
    (MUL, 'vectorized_elementwise_kernel<4, at::native::AUnaryFunctor'),
    ('synth_panel_kernel(Desc, int const*)', 'synth_panel_kernel(Desc'),
    ('Memcpy HtoD (Pageable -> Device)', 'Memcpy HtoD'),
    (SPIN, 'spin_kernel(long)'),
])
def test_kernel_name(name, head):
    assert profiling.kernel_name(name).startswith(head)


def test_measure_device_raises_without_a_card(tmp_path, monkeypatch):
    """A CPU-only process traces no device event: ``measure_device``
    raises, and never times the call on a host clock instead."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    chans = [wt.gaussian(1e-7) >> 2e-7]
    calls = []

    def fn():
        calls.append(1)
        return wt.synthesize(chans, 0.0, 1e-6, 2e9, engine='cuda-dense',
                             device='cpu')
    with pytest.raises(RuntimeError, match='no device events'):
        profiling.measure_device(fn, 'synth_dense_kernel', reps=2)
    assert len(calls) == 2
    log_dir = tmp_path / 'measure'
    log_dir.mkdir()
    (log_dir / 'old.1.pt.trace.json').write_text(json.dumps(kineto_trace()))
    with pytest.raises(RuntimeError, match='no device events'):
        profiling.measure_device(fn, 'synth_dense_kernel', reps=1,
                                 log_dir=str(log_dir))
    assert 'old.1.pt.trace.json' not in os.listdir(log_dir)


# -- the program's spans -------------------------------------------------

def _record(names=None, t0=0.0):
    """The record's spans (name, start, end) opened at or after ``t0``,
    those named in ``names`` where given."""
    rec = profiling.span_record()
    return [(n, s, e) for n, s, e in zip(rec.names, rec.starts, rec.ends)
            if s >= t0 and (names is None or n in names)]


def _cpu_profile():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU])


def test_a_span_off_enters_no_range_and_records_nothing(monkeypatch):
    """With no profiler recording, ``annotate`` enters no
    ``record_function``, reads no clock and leaves the record as it was."""
    entered, clock = [], []
    real = profiling.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    class Clock:
        def perf_counter(self):
            clock.append(1)
            return time.perf_counter()

    monkeypatch.setattr(profiling, 'record_function', counting)
    monkeypatch.setattr(profiling, 'time', Clock())
    before = profiling.span_record()
    for _ in range(3):
        with profiling.annotate('wf.test.off'):
            with profiling.annotate('wf.test.off_inner'):
                pass
    assert entered == [] and clock == []
    assert profiling.span_record() == before
    with _cpu_profile():
        with profiling.annotate('wf.test.on'):
            pass
    assert entered == ['wf.test.on'] and len(clock) == 2


def test_a_span_on_is_a_trace_range_and_a_record_entry(tmp_path):
    """Under ``torch.profiler.profile``, each ``wf.*`` span is one
    ``user_annotation`` event of the exported trace and one entry of the
    record, in the same order, with durations that agree within 50 us (the
    median over the spans: the two clocks are the host's, read on either
    side of the range, and the profiler's, read inside it); nested spans
    nest in the record."""
    names = ('wf.test.outer', 'wf.test.inner', 'wf.test.sibling')
    with _cpu_profile() as prof:
        with profiling.annotate('wf.test.warm_up'):
            pass
        t0 = time.perf_counter()
        with profiling.annotate('wf.test.outer'):
            for _ in range(3):
                with profiling.annotate('wf.test.inner'):
                    time.sleep(2e-4)
        for _ in range(16):
            with profiling.annotate('wf.test.sibling'):
                torch.zeros(8).add_(1)
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)['traceEvents']
    ranges = sorted((float(e['ts']), float(e['dur']), e['name'])
                    for e in events if e.get('ph') == 'X'
                    and e.get('cat') == 'user_annotation'
                    and e.get('name') in names)
    spans = _record(names, t0)
    assert [n for _, _, n in ranges] == [n for n, _, _ in spans] == [
        'wf.test.outer'] + ['wf.test.inner'] * 3 + ['wf.test.sibling'] * 16
    assert statistics.median(abs(dur / 1e6 - (e - s)) for (_, dur, _), (
        _, s, e) in zip(ranges, spans)) < 50e-6
    (_, s0, e0), *inner = spans[:4]
    assert all(s0 <= s < e <= e0 and e - s >= 2e-4 for _, s, e in inner)
    assert all(e <= s for (_, _, e), (_, s, _) in zip(spans[1:], spans[2:]))


def test_the_record_is_bounded_and_counts_what_it_dropped(monkeypatch):
    """A full record overwrites its oldest spans and counts them in
    ``dropped``; a span whose slot was taken while it was open is not
    recorded; the view is oldest first."""
    rec = profiling.SpanRecord(4)
    monkeypatch.setattr(profiling, '_RECORD', rec)
    with _cpu_profile():
        for i in range(6):
            with profiling.annotate(f'wf.test.s{i}'):
                pass
    view = profiling.span_record()
    assert view.names == ('wf.test.s2', 'wf.test.s3', 'wf.test.s4',
                          'wf.test.s5')
    assert view.dropped == 2 and len(view.starts) == len(view.ends) == 4
    assert list(view.starts) == sorted(view.starts)
    assert all(e >= s for s, e in zip(view.starts, view.ends))
    with _cpu_profile():
        with profiling.annotate('wf.test.long'):
            for i in range(4):
                with profiling.annotate(f'wf.test.t{i}'):
                    pass
    view = profiling.span_record()
    assert view.names == tuple(f'wf.test.t{i}' for i in range(4))
    assert view.dropped == 7
    # an open span is not in the view until it closes
    n = rec.open('wf.test.open', 1.0)
    assert 'wf.test.open' not in profiling.span_record().names
    rec.close(n, 2.0)
    view = profiling.span_record()
    assert view.names[-1] == 'wf.test.open' and view.dropped == 8
    assert (view.starts[-1], view.ends[-1]) == (1.0, 2.0)


def test_idle_by_span_puts_idle_time_on_the_innermost_span(tmp_path):
    """:func:`idle_by_span` on the card's trace with host spans added: the
    window runs from the first ``wf.*`` span to the last; the card's idle
    time (no kernel, copy or fill on a GPU timeline, the lead's spin kernel
    left out) goes to the innermost span open over it; ``pb.*`` ranges and
    the card's own annotation are not spans of the program."""
    trace = kineto_trace()

    def span(name, ts, dur):
        return {'ph': 'X', 'cat': 'user_annotation', 'name': name,
                'pid': 4242, 'tid': 1, 'ts': ts, 'dur': dur, 'args': {}}
    trace['traceEvents'] += [
        span('wf.outer', 0.0, 7000.0), span('wf.inner', 1700.0, 800.0),
        span('wf.late', 5500.0, 1000.0), span('pb.call', 0.0, 9000.0)]
    write(tmp_path, trace)
    idle = profiling.idle_by_span(str(tmp_path))
    # busy: [50, 50.9], [60, 60.7], [100, 1658.5], [2000, 5253],
    # [6000, 6004.5]; idle in [0, 7000] split by the innermost span
    assert set(idle) == {'wf.outer', 'wf.inner', 'wf.late'}
    assert idle['wf.outer'].seconds == pytest.approx(
        (50 + 9.1 + 39.3 + 41.5 + 247 + 500) / 1e6)
    assert idle['wf.outer'].longest == pytest.approx(500e-6)
    assert idle['wf.outer'].pieces == 6
    assert idle['wf.inner'] == pytest.approx((300e-6, 300e-6, 1))
    assert idle['wf.late'].seconds == pytest.approx(995.5e-6)
    assert idle['wf.late'].longest == pytest.approx(500e-6)
    assert idle['wf.late'].pieces == 2
    # time under no span of the program: the window's own ends
    trace['traceEvents'].append(span('wf.tail', 7500.0, 500.0))
    write(tmp_path, trace)
    idle = profiling.idle_by_span(str(tmp_path))
    assert idle[None] == pytest.approx((500e-6, 500e-6, 1))
    assert idle['wf.tail'] == pytest.approx((500e-6, 500e-6, 1))
    assert profiling.idle_by_span(str(tmp_path), prefix='zz.') == {}


def test_spans_between_reads_a_stretch_of_the_record(monkeypatch):
    """:func:`spans_between`: the durations of the matching spans that
    open inside the stretch and the count of marks; once the record has
    dropped its front, only the marks from the first at or after its
    oldest span, and only the spans from that mark on."""
    rec = profiling.SpanRecord(4)
    monkeypatch.setattr(profiling, '_RECORD', rec)
    for name, a, b in (('wf.a', 1.0, 1.5), ('wf.b', 2.0, 2.25),
                       ('wf.a', 3.0, 3.5), ('wf.a', 9.0, 9.5)):
        rec.close(rec.open(name, a), b)
    assert profiling.spans_between(1.5, 5.0, lambda n: n == 'wf.a',
                                   [1.5, 3.0]) == ([0.5], 2)
    for name, a, b in (('wf.a', 10.0, 10.25), ('wf.b', 11.0, 11.5)):
        rec.close(rec.open(name, a), b)
    assert profiling.span_record().dropped == 2
    assert profiling.spans_between(0.0, 20.0, lambda n: True,
                                   [1.0, 2.0, 3.0, 9.0]) == (
        [0.5, 0.5, 0.25, 0.5], 2)
    assert profiling.spans_between(0.0, 20.0, lambda n: True,
                                   [1.0, 2.0]) == ([], 0)
    assert profiling.spans_between(0.0, 20.0, lambda n: n == 'wf.b',
                                   ()) == ([0.5], 0)


def test_launched_under_follows_each_ops_launch(tmp_path):
    """:func:`launched_under`: the card's operations whose launch (the
    runtime or driver call with the operation's correlation id) lies
    inside a host range whose name matches the pattern -- whatever range
    the card's row draws over them; an operation launched outside, or with
    no launch in the trace, and the lead's spin kernel are left out."""
    trace = kineto_trace()
    correlation = {(K1, 100.0): 1, (K1, 300.0): 2, (K3, 2000.0): 3,
                   (MUL, 6000.0): 4, ('Memcpy HtoD (Pageable -> Device)',
                                      50.0): 5, (SPIN, 10.0): 6}
    for e in trace['traceEvents']:
        if (e['name'], e.get('ts')) in correlation:
            e['args'] = {'correlation': correlation[e['name'], e['ts']]}

    def host(name, cat, ts, dur, corr=None):
        return {'ph': 'X', 'cat': cat, 'name': name, 'pid': 4242, 'tid': 1,
                'ts': ts, 'dur': dur,
                'args': {} if corr is None else {'correlation': corr}}
    trace['traceEvents'] += [
        host('cudaLaunchKernel', 'cuda_runtime', 90.0, 1.0, 1),
        host('cudaLaunchKernel', 'cuda_runtime', 95.0, 1.0, 2),
        host('cudaLaunchKernel', 'cuda_runtime', 1900.0, 1.0, 3),
        host('cuLaunchKernel', 'cuda_driver', 5990.0, 1.0, 4),
        host('cudaMemcpyAsync', 'cuda_runtime', 40.0, 1.0, 5),
        host('cudaLaunchKernel', 'cuda_runtime', 8.0, 1.0, 6),
        host('user.region', 'user_annotation', 0.0, 200.0),
        host('wf.launch.a', 'user_annotation', 89.0, 3.0),
        host('wf.launch.b', 'user_annotation', 1890.0, 20.0),
        host('wf.x', 'user_annotation', 5980.0, 20.0)]
    write(tmp_path, trace)

    def found(pattern, cats=profiling.KERNELS):
        return [(e['name'], e['ts'])
                for e in profiling.launched_under(str(tmp_path), pattern,
                                                  cats)]
    assert found('user.region') == [(K1, 100.0), (K1, 300.0)]
    assert found('user.region', profiling.KERNELS + profiling.COPIES) == [
        ('Memcpy HtoD (Pageable -> Device)', 50.0), (K1, 100.0),
        (K1, 300.0)]
    assert found('wf.*') == [(K1, 100.0), (K3, 2000.0), (MUL, 6000.0)]
    assert found('wf.launch.b') == [(K3, 2000.0)]
    assert found('no.such.range') == []


def _tiny_table(n_schedules=3):
    from waveforms_tpu_torch.ops.lowering import lower_schedule
    return [lower_schedule([wt.cosPulse(40e-9) >> (1e-7 * (k + 1)),
                            wt.gaussian(30e-9) >> 2e-7], 0.0, 1.024e-6, 2e9)
            for k in range(n_schedules)]


def test_play_and_play_many_record_their_prepare_span():
    """``Sequencer.play_many`` opens one ``wf.play.prepare`` a call, dense
    or sparse; ``play`` one for its index and play_many's."""
    from waveforms_tpu_torch.ops import Sequencer
    seq = Sequencer(_tiny_table(), device='cpu')
    t0 = time.perf_counter()
    with _cpu_profile():
        seq.play_many([0, 2, 1], out_dtype=torch.int16)
        n_many = len(_record(t0=t0))
        seq.play_many([1], sparse=True)
        n_sparse = len(_record(t0=t0))
        seq.play(2)
    names = [n for n, _, _ in _record(t0=t0)]
    assert (n_many, n_sparse) == (1, 2)
    assert names == ['wf.play.prepare'] * 4


def test_run_sequence_loop_records_its_constants_once():
    """``run_sequence_loop`` (what a CPU device runs for ``run_sequence``)
    makes its constants in one ``wf.sequence.constants`` span, before the
    shots' plays."""
    from waveforms_tpu_torch.distortion import exp_decay_filter
    from waveforms_tpu_torch.ops import Sequencer
    from waveforms_tpu_torch.parallel import run_sequence, run_sequence_loop
    seq = Sequencer(_tiny_table(), device='cpu')
    kw = {'ba_filters': [exp_decay_filter(0.02, 3e-6, 2e9, inv=True)],
          'demod_freqs': [-121.64e6, -67.52e6]}
    for run in (run_sequence_loop, run_sequence):
        t0 = time.perf_counter()
        with _cpu_profile():
            iq = run(seq, [2, 0], **kw)
        names = [n for n, _, _ in _record(t0=t0)]
        assert iq.shape == (2, 2, 2)
        assert names == ['wf.sequence.constants'] + ['wf.play.prepare'] * 4


def test_predistort_device_records_its_three_stages():
    """``predistort_device``: ``wf.chain.coeffs`` (the combined filter and
    its steady state), ``wf.chain.iir``, ``wf.chain.fir``, in order and not
    nested; without filters or kernel, only the stages it runs."""
    from waveforms_tpu_torch.distortion import exp_decay_filter
    from waveforms_tpu_torch.ops import predistort_device
    x = torch.randn(2, 4096, dtype=torch.float64)
    filters = [exp_decay_filter(a, t, 2e9, inv=True)
               for a, t in ((0.02, 3e-6), (0.005, 20e-6))]
    ker = torch.hann_window(31, dtype=torch.float64)
    t0 = time.perf_counter()
    with _cpu_profile():
        predistort_device(x, filters=filters, ker=ker, device='cpu')
    spans = _record(t0=t0)
    assert [n for n, _, _ in spans] == ['wf.chain.coeffs', 'wf.chain.iir',
                                        'wf.chain.fir']
    assert all(e0 <= s1 for (_, _, e0), (_, s1, _) in zip(spans, spans[1:]))
    t0 = time.perf_counter()
    with _cpu_profile():
        predistort_device(x, ker=ker, device='cpu')
        predistort_device(x, filters=filters, device='cpu')
    assert [n for n, _, _ in _record(t0=t0)] == [
        'wf.chain.fir', 'wf.chain.coeffs', 'wf.chain.iir']


def test_a_kernel_launch_is_a_span_named_after_its_kernel():
    """A wrapper's launch on the card is the span ``wf.launch.<name>``
    (``wf.launch.<name>.shots`` for a shot entry), beside its counter; the
    plain version on the CPU is no launch and opens none."""
    from types import SimpleNamespace

    from waveforms_tpu_torch import kernels
    card_out = SimpleNamespace(device=torch.device('cuda'), shape=(3,))
    launched = []
    k = kernels._ShotKernel(
        'probe_x', 'csrc/x.cu', 'x.py:1', lambda *a: a[-2],
        lambda *a: launched.append('launch'),
        plain_shots=lambda *a: a[-2],
        launch_shots=lambda *a: launched.append('shots'))
    t0 = time.perf_counter()
    with _cpu_profile():
        k(None, card_out, None)
        k.shots(None, card_out, None)
        k(None, torch.zeros(3), None)
    assert launched == ['launch', 'shots']
    assert (k.launches, k.shot_launches) == (2, 1)
    assert [n for n, _, _ in _record(t0=t0)] == [
        'wf.launch.probe_x', 'wf.launch.probe_x.shots']
    assert kernels.synth_dense._span == 'wf.launch.synth_dense'
    assert kernels.iir_df2t._span == 'wf.launch.iir_df2t'
