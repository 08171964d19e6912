"""Device ms a view under the `field` span (hash grid and fused head)."""


def read(t):
    ms = t.span_ms("field")
    return None if ms is None else ms / t.units
