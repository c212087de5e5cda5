"""One reader a per-layer metric, ``<metric>.py`` with ``read(trace)``,
loaded by path (the names hold dots). A reader that finds nothing to read
returns None, and the harness leaves the metric out of the line."""
