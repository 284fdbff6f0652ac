"""``chain_roofline``: the least time of the window's signal chains over
their device time, in percent.

Least time: each call's float32 plane read once and its float64 output
written once (channels x samples x 12 bytes) over the card's published
HBM bandwidth.  Device time: everything launched inside the calls'
``pb.chain`` spans (the cast, the IIR, the FFT convolution), whatever
kernel does the work."""

import peaks


def chain_bytes(channels, samples):
    return channels * samples * (4 + 8)


def read(ctx):
    ops = ctx.view.call_ops('pb.chain')
    calls = {op.span.call for op in ops}
    device_s = sum(op.dur for op in ops) / 1e6
    if not calls or device_s <= 0:
        return None
    least_s = len(calls) * chain_bytes(ctx.cfg['n_channels'],
                                       ctx.call.n_samples) / \
        peaks.HBM_BYTES_PER_S
    return 100.0 * least_s / device_s
