"""The byte counts of both rooflines, worked out from the cells' shapes."""

from types import SimpleNamespace

import pytest

import peaks
import spec


def reader(name):
    return spec.metric_reader(name)


def play_many_call(shots, channels, samples, table_bytes_per_shot):
    return SimpleNamespace(
        shots=shots, table_bytes_per_shot=table_bytes_per_shot,
        output_bytes=lambda: shots * channels * samples * 2)


@pytest.mark.parametrize('cell, shots, channels, samples, out_bytes', [
    ('chip64.sweep', 4, 128, 2_000_000, 2_048_000_000),
    ('station_rb.upload', 1000, 2, 602_000, 2_408_000_000),
])
def test_synth_roofline_bytes(cell, shots, channels, samples, out_bytes):
    call = play_many_call(shots, channels, samples, 1000.0)
    want = out_bytes + shots * (1000.0 + 4)
    assert reader('synth_roofline').call_bytes(call) == want


def test_synth_roofline_bound_of_the_sweep():
    call = play_many_call(4, 128, 2_000_000, 0.0)
    bound_ms = reader('synth_roofline').call_bytes(call) / \
        peaks.HBM_BYTES_PER_S * 1e3
    assert bound_ms == pytest.approx(0.6113, abs=1e-4)


def test_chain_roofline_bytes_of_the_predistort_cell():
    m = reader('chain_roofline')
    assert m.chain_bytes(128, 2_000_000) == 3_072_000_000
    assert m.chain_bytes(128, 2_000_000) / peaks.HBM_BYTES_PER_S * 1e3 == \
        pytest.approx(0.917, abs=1e-3)


def test_rooflines_from_a_trace():
    """Least time over device time inside the calls' spans, whatever the
    kernels; nothing read where no call launched anything."""
    import tracing
    calls = [tracing.Span('pb.call', 0, 10, 0),
             tracing.Span('pb.call', 20, 30, 1)]
    chain = tracing.Span('pb.chain', 4, 9, 0)
    ops = [tracing.Op('k', 1, 100.0, calls[0]),
           tracing.Op('k', 21, 100.0, calls[1]),
           tracing.Op('fft', 5, 300.0, chain)]
    view = tracing.TraceView(ops, calls + [chain], (0, 600))
    call = play_many_call(4, 128, 2_000_000, 0.0)
    ctx = SimpleNamespace(view=view, call=call,
                          cfg={'n_channels': 128})
    call.n_samples = 2_000_000
    least = 2 * reader('synth_roofline').call_bytes(call) / \
        peaks.HBM_BYTES_PER_S
    assert reader('synth_roofline').read(ctx) == pytest.approx(
        100 * least / 500e-6)
    least_chain = 3_072_000_000 / peaks.HBM_BYTES_PER_S
    assert reader('chain_roofline').read(ctx) == pytest.approx(
        100 * least_chain / 300e-6)
    empty = SimpleNamespace(view=tracing.TraceView([], [], (0, 1)),
                            call=call, cfg=ctx.cfg)
    assert reader('synth_roofline').read(empty) is None
    assert reader('chain_roofline').read(empty) is None
