"""edit_ms_p95: the 95th percentile of the requests' waits in the traced
window, in ms, each from its circuit dict to its counts on the host. An
untimed reading beside ``edit_ms``: the tail an editor's user feels, which
spreads too widely from run to run to carry a bound."""

import statistics


def read(ctx):
    lat = [1e3 * r.latency_s for r in ctx.requests]
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20)[-1]
