"""Minutiae extraction and quality postprocessing of the port."""

from .minutiae import (MinutiaeSet, crossing_number, extract_minutiae,
                       from_matrix, minutiae_from_numpy)
from .quality import postprocess_minutiae
