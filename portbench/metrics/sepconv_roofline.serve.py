"""sepconv's share of its roofline, %: the least time of the traced
requests' sepconv calls (bounds from their shapes) over the device time of
the work launched inside the benchmark's spans around each call."""


def read(r):
    bound, spent = r.counts.get("sepconv_bound_s"), r.trace.span_s("portbench.sepconv")
    return 100.0 * bound / spent if bound and spent else None
