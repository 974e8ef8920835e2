"""The edge half of a fleet step: the spans ``edge.decode`` (the edge
tower's launches) and ``edge.trigger`` (which ends in the step's readback
of u, so it holds the edge's device time), ms a step over the window."""


def read(run):
    ms = sum(s.dur for s in run.spans
             if s.name in ("edge.decode", "edge.trigger")) * 1e3
    return ms / run.steps if run.steps else None
