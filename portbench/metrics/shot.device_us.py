"""``shot.device_us``: the card's time of the window's calls over their
shots, in microseconds: every kernel, fill and copy launched inside the
calls' spans (a graph's replays included) over the shots those calls
ran."""


def read(ctx):
    ops = ctx.view.call_ops()
    calls = {op.span.call for op in ops}
    if not calls:
        return None
    return sum(op.dur for op in ops) / (len(calls) * ctx.call.shots)
