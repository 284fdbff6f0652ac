"""``kernel.launch_us``: the mean host microseconds of a kernel launch in
the traced window -- the program's spans ``wf.launch.<kernel>`` (the
ctypes launch of each of its kernels), on the host clock.

The program records a span only under a profiler, so this is the launch's
cost under tracing: the profiler's own callbacks on the launch fall inside
the span.  The untraced cost of the same launches is far smaller."""


def read(ctx):
    from waveforms_tpu_torch.utils import profiling
    between = getattr(profiling, 'spans_between', None)
    if between is None:                 # a program that records no span
        return None
    win = ctx.window
    durs, calls = between(win.t0, win.t1,
                          lambda n: n.startswith('wf.launch.'), win.issue)
    return sum(durs) * 1e6 / len(durs) if durs and calls else None
