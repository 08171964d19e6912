"""Device ms a step under the `join` span (the ranks' all-reduce)."""


def read(t):
    ms = t.span_ms("join")
    return None if ms is None else ms / t.units
