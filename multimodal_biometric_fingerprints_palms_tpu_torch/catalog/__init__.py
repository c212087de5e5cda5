"""Dataset catalog of the port: filename parsing, the catalog CSV, the id
consistency check."""

from .parse import parse_filename, PATTERN_STANDARD, PATTERN_NIST, PATTERN_S
from .catalog import scan_cluster, scan_dataset, save_catalog, CATALOG_COLUMNS
from .verify import check_id_consistency
