"""sepconv's share of its roofline in training, %: the least time of the
traced steps' forward calls and of both adjoints (bounds from shapes) over
the device time inside the spans around each forward call and inside the
sepconv Function's autograd node."""


def read(r):
    bound = r.counts.get("sepconv_bound_s")
    fwd = r.trace.span_s("portbench.sepconv")
    bwd = r.trace.device_s(lambda name: "SepConvBackward" in name)
    return 100.0 * bound / (fwd + bwd) if bound and fwd and bwd else None
