"""The int8 conv's share of its roofline, %: the least time of the traced
requests' int8 conv calls (bounds from their shapes) over the device time
inside the benchmark's spans around each QConv forward."""


def read(r):
    bound, spent = r.counts.get("qconv_bound_s"), r.trace.span_s("portbench.qconv")
    return 100.0 * bound / spent if bound and spent else None
