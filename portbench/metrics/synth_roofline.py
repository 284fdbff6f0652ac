"""``synth_roofline``: the least time of the window's synthesis calls over
their device time, in percent.

Least time: each call's bytes over the card's published HBM bandwidth --
the output plane written once (shots x channels x samples x the output's
bytes a sample), the played shots' descriptor rows read once (the table's
bytes a point) and the shots' indices read once (4 bytes each).  Device
time: every kernel, fill and copy launched inside the calls' spans,
whatever kernel does the work."""

import peaks


def call_bytes(call):
    """Bytes a call must move at the least: its output once, and each
    shot's descriptor rows and index once."""
    return call.output_bytes() + call.shots * (call.table_bytes_per_shot + 4)


def read(ctx):
    ops = ctx.view.call_ops()
    calls = {op.span.call for op in ops}
    device_s = sum(op.dur for op in ops) / 1e6
    if not calls or device_s <= 0:
        return None
    least_s = len(calls) * call_bytes(ctx.call) / peaks.HBM_BYTES_PER_S
    return 100.0 * least_s / device_s
