"""The window's share of the card's peak, %: the work done in the traced
window (the plain reference's operations at the cell's shapes, each class
at its data-sheet rate: bf16 at the bf16 tensor-core rate, int8 convs at
the int8 rate) as seconds at peak, over the window's length."""


def read(r):
    at_peak = r.counts.get("at_peak_s")
    return 100.0 * at_peak / r.trace.window_s if at_peak else None
