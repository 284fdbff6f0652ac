"""``api.host_ms``: the host's milliseconds from a call's issue to its
return, before the wait, averaged over the traced window's calls (the
benchmark's own span ``pb.call`` on the host clock)."""


def read(ctx):
    win = ctx.window
    if not win.calls:
        return None
    return sum(r - i for r, i in zip(win.ret, win.issue)) * 1e3 / win.calls
