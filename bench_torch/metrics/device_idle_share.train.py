"""device_idle_share.train (%): the share of the traced steps' stretch in
which no kernel, copy or fill ran on the card."""


def read(ctx, outcome):
    tr = outcome.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
