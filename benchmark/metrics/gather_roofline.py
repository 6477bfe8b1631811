"""The gathers' share of their roofline: the least time the card could
take for every forward gather call of the traced window (the operands of
each call into quad_gather / quad_gather_rows, counted by
benchmark/roofline.py) over the device time of the operations launched
inside those calls, in %."""

from benchmark import roofline


def read(trace):
    calls = trace.records.get("gather", [])
    ops = trace.under("gather")
    if not calls or not ops:
        return None
    least = sum(roofline.gather_least_s(*args[:5]) for args in calls)
    return 100.0 * least / trace.busy(ops)
