"""Config loading of the port."""

from .loader import (
    ConfigNode,
    load_yaml_config,
    load_fingerprint_config,
    load_classifier_config,
    load_matching_config,
    load_segmentation_config,
)
