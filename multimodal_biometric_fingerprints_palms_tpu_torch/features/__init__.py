"""Minutiae extraction and quality postprocessing of the port."""

from .minutiae import MinutiaeSet, crossing_number, extract_minutiae
from .quality import postprocess_minutiae
