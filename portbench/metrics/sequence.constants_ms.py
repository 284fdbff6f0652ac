"""``sequence.constants_ms``: the host milliseconds a call in the
program's span ``wf.sequence.constants`` (the shot loop's constants: the
combined filter, its initial state and its constants on the card, the
demodulation matrix and its upload, the indices), over the traced
window's calls, on the host clock."""

SPAN = 'wf.sequence.constants'


def read(ctx):
    from waveforms_tpu_torch.utils import profiling
    between = getattr(profiling, 'spans_between', None)
    if between is None:                 # a program that records no span
        return None
    win = ctx.window
    durs, calls = between(win.t0, win.t1, lambda n: n == SPAN, win.issue)
    return sum(durs) * 1e3 / calls if durs and calls else None
