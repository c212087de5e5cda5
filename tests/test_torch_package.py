"""Package-level checks of the PyTorch/CUDA port: it imports neither JAX nor
OpenCV, its public signatures and defaults equal the JAX package's, its
kernel sources exist, and its kernel wrappers never fall back to the plain
version for a tensor that is not on the CPU."""

import importlib
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_biometric_fingerprints_palms_tpu_torch.kernels import build
from multimodal_biometric_fingerprints_palms_tpu_torch.ops import (
    cuda_cc, cuda_kernels, cuda_thin)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = "multimodal_biometric_fingerprints_palms_tpu"
PORT_PKG = "multimodal_biometric_fingerprints_palms_tpu_torch"

# (module, function names) of the slice, under both packages
SLICE = {
    "ops.filters": ["conv2d_same", "gaussian_kernel1d", "gaussian_blur",
                    "gaussian_blur_cv", "box_filter", "blur_mean", "sobel"],
    "ops.histogram": ["histogram256", "quantiles_bisect", "quantiles_u8",
                      "quantiles_approx", "percentile_stretch",
                      "_otsu_from_hist", "otsu_threshold",
                      "otsu_threshold_patchwise", "clahe"],
    "ops.denoise": ["nlm_denoise"],
    "ops.morphology": ["ellipse_se", "binary_dilate", "binary_erode",
                       "binary_opening", "binary_closing",
                       "binary_close_open_packed",
                       "binary_reconstruction_by_dilation"],
    "ops.components": ["connected_components", "component_sizes",
                       "remove_small_objects", "remove_small_holes",
                       "clean_mask", "largest_component", "convex_hull_mask",
                       "mask_bbox"],
    "ops.skeleton": ["neighbor_count", "skeletonize", "prune_isolated"],
    "ops.orientation": ["compute_orientation_field"],
    "ops.geometry": ["upsample_bilinear_matmul"],
    "preprocessing.enhance": ["normalize_image", "denoise_image",
                              "segment_fingerprint", "binarize",
                              "smooth_fingerprint_skeleton",
                              "thinning_and_cleaning",
                              "preprocess_fingerprint"],
    "features.minutiae": ["crossing_number", "extract_minutiae"],
    "features.quality": ["postprocess_minutiae"],
}
# The port keeps no use_pallas switch: it is the use_pallas=False
# configuration, with the kernels chosen by the tensor's device.
DROPPED = {"use_pallas"}


def _params(fn, drop=()):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()
            if p.name not in drop]


def test_port_imports_neither_jax_nor_cv2():
    code = ("import sys; import {0}.preprocessing, {0}.features, {0}.ops; "
            "import {0}.kernels.build; "
            "bad = [m for m in ('jax', 'cv2') if m in sys.modules]; "
            "sys.exit(1 if bad else 0)").format(PORT_PKG)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("module", sorted(SLICE))
def test_signatures_match_jax(module):
    jm = importlib.import_module(f"{JAX_PKG}.{module}")
    tm = importlib.import_module(f"{PORT_PKG}.{module}")
    for name in SLICE[module]:
        assert (_params(getattr(jm, name), DROPPED)
                == _params(getattr(tm, name))), f"{module}.{name}"


def test_named_tuples_match_jax():
    pairs = [("features.minutiae", "MinutiaeSet"),
             ("ops.orientation", "OrientationField"),
             ("preprocessing.enhance", "EnhancementResult")]
    for module, name in pairs:
        jt = getattr(importlib.import_module(f"{JAX_PKG}.{module}"), name)
        tt = getattr(importlib.import_module(f"{PORT_PKG}.{module}"), name)
        assert jt._fields == tt._fields, name


def test_kernel_sources_exist():
    assert build.SOURCES
    for name in build.SOURCES:
        assert (build.CSRC_DIR / name).is_file(), name
    # the build directory is git-ignored
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_launch_counters_untouched_on_cpu():
    before = dict(build.LAUNCHES)
    m = torch.from_numpy(np.random.default_rng(0).random((1, 16, 16)) < 0.5)
    cuda_cc.cc_filter(m, "clean", 1, min_size=3, max_size=3)
    cuda_thin.zs_thin(m)
    cuda_kernels.clahe(m.float(), 2.0, 8)
    assert build.LAUNCHES == before


@pytest.mark.parametrize("call", [
    lambda t: cuda_kernels.clahe(t.float(), 2.0, 8),
    lambda t: cuda_cc.cc_filter(t, "largest", 2),
    lambda t: cuda_cc.cc_label(t, 2),
    lambda t: cuda_thin.zs_thin(t),
])
def test_wrappers_raise_off_cpu_without_cuda(call):
    """A tensor that is not on the CPU never takes the plain path."""
    t = torch.zeros((1, 16, 16), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(t)
