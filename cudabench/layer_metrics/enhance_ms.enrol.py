"""Median host ms of the synchronised span around ``preprocess_fingerprint``
over a batch, across the traced window's steps."""


def read(tr):
    return tr.spans.median_ms("enhance")
