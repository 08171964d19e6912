"""Device ms a step under the `backward` span (hash-grid backward, segment
sum, MLP gradients)."""


def read(t):
    ms = t.span_ms("backward")
    return None if ms is None else ms / t.units
