"""``device.idle_share``: the share of the traced window, in percent, in
which the card's timeline holds no kernel, fill or copy."""


def read(ctx):
    window = ctx.view.window_s
    if window <= 0 or not ctx.view.ops:
        return None
    return 100.0 * (1.0 - ctx.view.busy_s() / window)
