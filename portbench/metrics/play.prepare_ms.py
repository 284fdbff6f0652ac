"""``play.prepare_ms``: the host milliseconds a call in the program's span
``wf.play.prepare`` (``Sequencer.play`` / ``play_many``'s host work
before the launch: the checks, the DAC scale, the indices, the output's
allocation), over the traced window's calls, on the host clock."""

SPAN = 'wf.play.prepare'


def read(ctx):
    from waveforms_tpu_torch.utils import profiling
    between = getattr(profiling, 'spans_between', None)
    if between is None:                 # a program that records no span
        return None
    win = ctx.window
    durs, calls = between(win.t0, win.t1, lambda n: n == SPAN, win.issue)
    return sum(durs) * 1e3 / calls if durs and calls else None
