"""Host ms of the program's ``gallery.screen`` span in the profiled sweep:
``shard_blocks_screen`` as ``all_pairs_unique`` calls it, ending after the
mask's copy to the host, so it holds the device's work."""

from cudabench.layer_metrics._program import host_ms


def read(tr):
    return host_ms(tr, "gallery.screen")
