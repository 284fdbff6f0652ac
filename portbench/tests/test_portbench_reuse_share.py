"""The reader of ``sequence.reuse_share`` on a synthetic record and
window: 100% where every call reused its kept shot program, 75% where the
first call built it, and None where the record holds no
``wf.sequence.reuse`` span or the program records no span at all."""

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
HITS = sorted([('wf.sequence.constants', t, t + 0.001)
               for t in WINDOW.issue]
              + [('wf.sequence.reuse', t + 0.001, t + 0.0011)
                 for t in WINDOW.issue], key=lambda s: s[1])
# a program that keeps no shot program: every call captures
MISSES = [('wf.sequence.constants', 10.0, 10.002),
          ('wf.sequence.capture', 10.01, 10.31),
          ('wf.sequence.replay', 10.31, 10.33),
          ('wf.sequence.constants', 40.0, 40.004),
          ('wf.sequence.capture', 40.01, 40.11)]


def read():
    ctx = SimpleNamespace(window=WINDOW)
    return spec.metric_reader('sequence.reuse_share').read(ctx)


def use(monkeypatch, spans):
    names, starts, ends = zip(*spans) if spans else ((), (), ())
    monkeypatch.setattr(profiling, 'span_record', lambda: profiling.Spans(
        names, starts, ends, 0))


@pytest.mark.parametrize('spans, want', [
    (HITS, 100.0),
    ([s for s in HITS if s[0] != 'wf.sequence.reuse' or s[1] > 11.0], 75.0),
    (MISSES, None),
    ([], None),
])
def test_reuse_share_reads_the_calls_that_reused_their_program(
        monkeypatch, spans, want):
    use(monkeypatch, spans)
    got = read()
    assert got is None if want is None else got == pytest.approx(want)


def test_reuse_share_of_a_program_without_span_records_is_none(monkeypatch):
    use(monkeypatch, HITS)
    monkeypatch.delattr(profiling, 'spans_between')
    assert read() is None
