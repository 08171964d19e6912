"""Points a view where the host waited for the card (the `host_read`
spans: each round's and each pre-pass's test for live rays, the
compactions' nonzero, the sample totals), mean over the device part's
views."""

from portbench import program


def read(t):
    tr, units = program.units(t, "view")
    if not units:
        return None
    want = set(units)
    return sum(s.name == "host_read" and s.unit in want
               for s in tr.spans) / len(units)
