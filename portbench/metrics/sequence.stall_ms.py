"""``sequence.stall_ms``: the longest single span of the shot loop in the
traced window -- the program's ``wf.sequence.*`` spans (constants, the
eager shot, the capture, the replays), on the host clock: the tail of a
call's host work."""


def read(ctx):
    from waveforms_tpu_torch.utils import profiling
    between = getattr(profiling, 'spans_between', None)
    if between is None:                 # a program that records no span
        return None
    win = ctx.window
    durs, calls = between(win.t0, win.t1,
                          lambda n: n.startswith('wf.sequence.'), win.issue)
    return max(durs) * 1e3 if durs and calls else None
