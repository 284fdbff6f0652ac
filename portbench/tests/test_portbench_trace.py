"""The trace reader: device operations attributed to the host span open at
their launch, busy time, the idle share and the breakdown."""

import pytest

import tracing


def X(name, cat, ts, dur, pid, **args):
    return {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur,
            'pid': pid, 'tid': 1, 'args': args}


EVENTS = [
    {'ph': 'M', 'name': 'process_name', 'pid': 0, 'args': {'name': 'GPU 0'}},
    {'ph': 'M', 'name': 'process_name', 'pid': 9, 'args': {'name': 'CPU'}},
    X('pb.call', 'user_annotation', 100, 50, 9),
    X('pb.chain', 'user_annotation', 120, 20, 9),
    X('pb.wait', 'user_annotation', 150, 300, 9),
    X('pb.call', 'user_annotation', 500, 40, 9),
    X('pb.wait', 'user_annotation', 540, 100, 9),
    X('cudaLaunchKernel', 'cuda_runtime', 105, 5, 9, correlation=1),
    X('cudaLaunchKernel', 'cuda_runtime', 125, 5, 9, correlation=2),
    X('cudaGraphLaunch', 'cuda_runtime', 505, 5, 9, correlation=3),
    X('cudaLaunchKernel', 'cuda_runtime', 10, 5, 9, correlation=4),
    X('void ns::synth_dense_shots_kernel<4>(Desc)', 'kernel', 110, 100, 0,
      correlation=1),
    X('iir_chunk_kernel', 'kernel', 210, 200, 0, correlation=2),
    X('Memset (Device)', 'gpu_memset', 520, 60, 0, correlation=3),
    X('void at::native::spin_kernel(long)', 'kernel', 15, 1, 0,
      correlation=4),
    X('gpu annotation', 'gpu_user_annotation', 110, 400, 0),
]


def test_ops_are_attributed_to_the_span_open_at_their_launch():
    view = tracing.read_events(EVENTS)
    assert view.window == (100, 640)
    assert [s.call for s in view.spans] == [0, 0, None, 1, None]
    names = [(op.name, op.span.name, op.span.call) for op in view.ops]
    assert names == [('synth_dense_shots_kernel', 'pb.call', 0),
                     ('iir_chunk_kernel', 'pb.chain', 0),
                     ('Memset', 'pb.call', 1)]
    assert [op.name for op in view.call_ops('pb.chain')] == [
        'iir_chunk_kernel']


def test_busy_idle_and_breakdown():
    view = tracing.read_events(EVENTS)
    assert view.busy() == [(110, 410), (520, 580)]
    assert view.busy_s() == pytest.approx(360e-6)
    assert view.window_s == pytest.approx(540e-6)
    b = tracing.breakdown(view)
    assert b['device_ops'][0] == ['pb.chain/iir_chunk_kernel',
                                  pytest.approx(200e-6)]
    idle = dict((k.split(' (')[0], v) for k, v in b['idle_gaps'])
    # idle [100, 110] under the first call, [410, 450] under its wait,
    # [450, 500] between calls, [500, 520] under the second call, [580,
    # 640] under its wait
    assert idle == {'pb.call': pytest.approx(30e-6),
                    'pb.wait': pytest.approx(100e-6),
                    'between calls': pytest.approx(50e-6)}
    assert sum(idle.values()) == pytest.approx(view.window_s
                                               - view.busy_s())


def test_short_names():
    assert tracing.short_name(
        'void wfsynth::synth_dense_kernel<false, 4>(wfsynth::Desc)') == \
        'synth_dense_kernel'
    assert tracing.short_name('Memcpy HtoD (Pinned -> Device)') == \
        'Memcpy HtoD'
