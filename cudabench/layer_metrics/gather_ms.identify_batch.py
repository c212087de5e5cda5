"""Device milliseconds a profiled call of rank 0's NCCL kernels: the probe
broadcast (``gallery.broadcast``) and the score gather
(``gallery.gather``), the only collectives of a call. The gather's kernel
runs until the slowest rank has sent its block, so what it reads above
the transfer itself is rank 0 waiting for that rank. None without those
spans or without a device operation."""

from cudabench.layer_metrics._program import spans


def read(tr):
    prof = tr.profiles.get("steps")
    names = {s.name for s in spans(tr)}
    if prof is None or not {"gallery.broadcast", "gallery.gather"} <= names:
        return None
    calls = prof.intervals("identify_batch")
    per_call = [sum(e - s for n, s, e in prof.ops_within(a, b)
                    if "nccl" in n.lower()) / 1e3 for a, b in calls]
    return sum(per_call) / len(per_call) if calls and any(per_call) else None
