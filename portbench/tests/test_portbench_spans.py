"""The readers of the program's spans: each span metric on a synthetic
record and window -- the value, the spans kept (those that start inside
the window), None where the record holds none, and the calls counted
where the record dropped its oldest spans."""

from array import array
from types import SimpleNamespace

import pytest

import harness
import spec
from waveforms_tpu_torch.utils import profiling

# the window: 4 calls issued at 10, 20, 30, 40 s, the last done at 50 s
WINDOW = harness.Window(issue=array('d', [10.0, 20.0, 30.0, 40.0]),
                        ret=array('d', [11.0, 21.0, 31.0, 41.0]),
                        ms=array('d', [1.0] * 4), t0=10.0, t1=50.0)
SPANS = [
    ('wf.sequence.constants', 5.0, 5.5),      # before the window
    ('wf.sequence.constants', 10.0, 10.002),
    ('wf.sequence.eager_shot', 10.002, 10.01),
    ('wf.sequence.capture', 10.01, 10.31),
    ('wf.sequence.replay', 10.31, 10.33),
    ('wf.play.prepare', 20.0, 20.004),
    ('wf.launch.synth_dense.shots', 20.004, 20.00401),
    ('wf.chain.coeffs', 30.0, 30.001),
    ('wf.launch.iir_df2t', 30.001, 30.00103),
    ('wf.sequence.constants', 40.0, 40.004),
    ('wf.sequence.capture', 40.01, 40.11),
    ('wf.play.prepare', 40.2, 40.202),
    ('wf.chain.coeffs', 51.0, 52.0),          # after the window
]


def reader(name):
    return spec.metric_reader(name).read


def ctx(window=WINDOW):
    return SimpleNamespace(window=window)


def use(monkeypatch, spans, dropped=0):
    names, starts, ends = zip(*spans) if spans else ((), (), ())
    monkeypatch.setattr(profiling, 'span_record', lambda: profiling.Spans(
        names, starts, ends, dropped))


@pytest.mark.parametrize('name, want', [
    ('sequence.constants_ms', (2 + 4) / 4),
    ('sequence.capture_ms', (300 + 100) / 4),
    ('sequence.stall_ms', 300.0),
    ('play.prepare_ms', (4 + 2) / 4),
    ('chain.coeffs_ms', 1 / 4),
    ('kernel.launch_us', (10 + 30) / 2),
])
def test_each_metric_reads_the_spans_inside_the_window(monkeypatch, name,
                                                       want):
    use(monkeypatch, SPANS)
    assert reader(name)(ctx()) == pytest.approx(want)


@pytest.mark.parametrize('name', ['sequence.constants_ms',
                                  'sequence.capture_ms', 'sequence.stall_ms',
                                  'play.prepare_ms', 'chain.coeffs_ms',
                                  'kernel.launch_us'])
def test_no_span_reads_as_none(monkeypatch, name):
    """An empty record, a record of other spans, a record with spans only
    outside the window, an empty window, and a program with no record."""
    use(monkeypatch, [])
    assert reader(name)(ctx()) is None
    use(monkeypatch, [('pb.call', 10.0, 11.0), ('wf.other', 10.0, 11.0)])
    assert reader(name)(ctx()) is None
    use(monkeypatch, [(n, s + 100, e + 100) for n, s, e in SPANS])
    assert reader(name)(ctx()) is None
    use(monkeypatch, SPANS)
    assert reader(name)(ctx(harness.Window(t0=10.0, t1=50.0))) is None
    monkeypatch.delattr(profiling, 'span_record')
    monkeypatch.delattr(profiling, 'spans_between')
    assert reader(name)(ctx()) is None


def test_a_record_that_dropped_its_front_counts_the_calls_it_covers(
        monkeypatch):
    """The record's oldest span at 20.004 s: the calls issued from 30 s on
    are covered (2 of 4), and only the spans from that issue on count."""
    kept = [s for s in SPANS if s[1] >= 20.004]
    use(monkeypatch, kept, dropped=6)
    assert reader('play.prepare_ms')(ctx()) == pytest.approx(2 / 2)
    assert reader('sequence.capture_ms')(ctx()) == pytest.approx(100 / 2)
    assert reader('chain.coeffs_ms')(ctx()) == pytest.approx(1 / 2)
    assert reader('kernel.launch_us')(ctx()) == pytest.approx(30.0)
    assert reader('sequence.stall_ms')(ctx()) == pytest.approx(100.0)
    # a record whose every span is older than the window's last issue
    use(monkeypatch, [s for s in SPANS if s[1] >= 40.2], dropped=11)
    assert reader('play.prepare_ms')(ctx()) is None
