"""Dataset filename parsing (a copy of the JAX package's
``catalog/parse.py``).

Reproduces the three filename schemas recognized by the reference
(src/catalog/prepare_catalog.py:13-55):

- standard PolyU ``<subject>_<finger>_<session>.<ext>``
- NIST ``F<4-digit>_<n>.<ext>`` (session fixed to 1)
- S-pattern ``S<4-digit>_<n>.<ext>`` (session fixed to 1)
"""

from __future__ import annotations

import re

_EXT = r"\.(?:jpg|jpeg|png|bmp|tif|tiff)$"

PATTERN_STANDARD = re.compile(r"^(\d+)_(\d+)_(\d+)" + _EXT, re.IGNORECASE)
PATTERN_NIST = re.compile(r"^F(\d{4})_(\d+)" + _EXT, re.IGNORECASE)
PATTERN_S = re.compile(r"^S(\d{4})_(\d+)" + _EXT, re.IGNORECASE)


def parse_filename(filename: str) -> tuple[int, int, int] | None:
    """Return (subject_id, finger_id, session_id) or None if unrecognized."""
    m = PATTERN_STANDARD.match(filename)
    if m:
        return int(m.group(1)), int(m.group(2)), int(m.group(3))
    m = PATTERN_NIST.match(filename)
    if m:
        return int(m.group(1)), int(m.group(2)), 1
    m = PATTERN_S.match(filename)
    if m:
        return int(m.group(1)), int(m.group(2)), 1
    return None


def user_id_from_filename(filename: str) -> str:
    """User grouping key: prefix before the first underscore
    (reference convention, src/matching/match_features.py:34)."""
    return filename.split("_")[0]
