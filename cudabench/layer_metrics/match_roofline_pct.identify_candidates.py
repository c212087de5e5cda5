"""The least time of the profiled cascade calls' hypothesis scoring
(``work.hypothesis_work``: valid-slot distances x H x 10 operations, and
its tensors' bytes), % of the device time of the whole calls: the
screen's H over every probe x row pair, plus the full pass's H over the
pairs it promoted (the program's ``gallery.promoted_pairs``). None without
device time or without the count. The search without the cascade is
``match_roofline_pct.identify_batch``'s."""

from cudabench.layer_metrics._program import counted
from cudabench.layer_metrics._shared import roofline_pct


def read(tr):
    screen = tr.work.get("identify_batch")
    pair = tr.work.get("identify_batch.full_pair")
    promoted = counted(tr, "gallery.promoted_pairs")
    if screen is None or pair is None or promoted is None:
        return None
    # the promoted pairs' full pass spread over the calls: the ratio sums
    # numerator and denominator over them
    full = promoted * pair / len(screen)
    return roofline_pct(tr, "steps", "identify_batch", [s + full for s in screen])
