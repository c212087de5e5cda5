"""Host ms of the synchronised span around ``shard_blocks_screen`` over the
whole gallery, called alone once in the traced run."""


def read(tr):
    return tr.spans.median_ms("screen")
