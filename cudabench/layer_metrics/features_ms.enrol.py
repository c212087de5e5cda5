"""Median host ms of the synchronised span around ``extract_minutiae`` +
``postprocess_minutiae`` over a batch, across the traced window's steps."""


def read(tr):
    return tr.spans.median_ms("features")
