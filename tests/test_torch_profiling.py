"""The port's profiling hooks (``waveforms_tpu_torch.utils.profiling``) on
the CPU: a trace with its annotation, the reader of the card's events on a
Kineto trace of the card's own shape, and no host clock in place of the
card's.  The card's case is ``tests/test_torch_cuda_fuzz.py``'s
``test_measure_device_times_k1``.
"""

import gzip
import json
import os

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
