"""Unique pairs the blocked screen promotes to the full pass, % of all
unique pairs (the same call as ``screen_ms.all_pairs``)."""


def read(tr):
    n = tr.counters.get("unique_pairs")
    return None if not n else 100.0 * tr.counters["promoted_pairs"] / n
