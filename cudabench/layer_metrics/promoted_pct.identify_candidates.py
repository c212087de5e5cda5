"""The penetration rate: pairs the program's cascade screen promoted
(``gallery.promoted_pairs``), % of the pairs it screened
(``gallery.screen_pairs``), over the profiled calls. None without those
counts."""

from cudabench.layer_metrics._program import counted


def read(tr):
    screened = counted(tr, "gallery.screen_pairs")
    promoted = counted(tr, "gallery.promoted_pairs")
    return None if not screened or promoted is None else 100.0 * promoted / screened
