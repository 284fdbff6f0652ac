"""``sequence.reuse_share``: the share (%) of the traced window's calls
whose ``run_sequence`` reused the shot program kept on the Sequencer --
the program's span ``wf.sequence.reuse``, one a call that found its
program kept -- over the calls the record covers."""

SPAN = 'wf.sequence.reuse'


def read(ctx):
    from waveforms_tpu_torch.utils import profiling
    between = getattr(profiling, 'spans_between', None)
    if between is None:                 # a program that records no span
        return None
    win = ctx.window
    durs, calls = between(win.t0, win.t1, lambda n: n == SPAN, win.issue)
    return len(durs) * 100.0 / calls if durs and calls else None
