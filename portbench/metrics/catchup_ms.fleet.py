"""The server's catch-up in a fleet step: the span ``edge.catchup`` (the
masked decode rounds over every backlog and the combine, ending in the
readback of fhat), mean ms over the window's steps that raised alarms."""


def read(run):
    durs = [s.dur for s in run.spans if s.name == "edge.catchup"]
    return sum(durs) / len(durs) * 1e3 if durs else None
