"""Device idle time while the host was inside the sweep's
``gallery.screen`` span (the blocked screen, to its mask on the host), %
of the profiled sweep's window."""

from cudabench.layer_metrics._program import idle_pct


def read(tr):
    return idle_pct(tr, "gallery.screen")
