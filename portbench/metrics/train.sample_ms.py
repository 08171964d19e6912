"""Device ms a step under the trainer's `sample` span (ray batch draw)."""


def read(t):
    ms = t.span_ms("sample")
    return None if ms is None else ms / t.units
