"""Device time of host-device copies per request, ms: the profiler's memcpy
events in the traced window over the requests completed in it."""


def read(r):
    n = r.counts.get("requests")
    return r.trace.memcpy_s() * 1e3 / n if n else None
