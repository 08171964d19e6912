"""Device ms a view under the `first_hit` and `march` spans."""


def read(t):
    ms = t.span_ms("first_hit", "march")
    return None if ms is None else ms / t.units
