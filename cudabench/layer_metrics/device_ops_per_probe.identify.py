"""Device operations the profiler records per ``identify`` call."""


def read(tr):
    prof = tr.profiles.get("steps")
    calls = [] if prof is None else prof.intervals("identify")
    ops = sum(len(prof.ops_within(s, e)) for s, e in calls) if calls else 0
    return ops / len(calls) if ops else None
