"""Share of the window, in %, in which no operation ran on the device: one
less the union of the trace's kernel, copy and set intervals inside the
libraries' ranges over the ranges' length."""


def read(rec):
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
