"""The share of the traced window in which the card runs no operation, in
%."""


def read(r):
    t = r.trace
    if t.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - t.busy_s / t.window_s)
