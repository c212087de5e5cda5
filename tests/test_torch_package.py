"""Package-level checks of the PyTorch/CUDA port: it imports none of JAX,
flax, optax, OpenCV, PIL, PyYAML, pandas, matplotlib or the JAX package
(the card's machine lacks some, and the port carries its own codec, YAML
reader, CSV writer and optimizer), its public signatures and defaults
equal the JAX package's, its kernel sources exist, its kernel wrappers
never fall back to the plain version for a tensor that is not on the CPU,
and its entry points run on the card unless the caller asks for the
CPU."""

import ast
import importlib
import inspect
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_biometric_fingerprints_palms_tpu_torch.kernels import build
from multimodal_biometric_fingerprints_palms_tpu_torch.ops import (
    cuda_binarize, cuda_cc, cuda_kernels, cuda_morph, cuda_nlm, cuda_thin,
    denoise)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils import threefry

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = "multimodal_biometric_fingerprints_palms_tpu"
PORT_PKG = "multimodal_biometric_fingerprints_palms_tpu_torch"
# what neither the port nor the scripts that run it on the card may import
FORBIDDEN = ("jax", "flax", "optax", "msgpack", "cv2", "PIL", "yaml",
             "pandas", "matplotlib", "sklearn", JAX_PKG)
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in (ROOT / PORT_PKG).rglob("*.py") if p.name != "__init__.py")

# (module, function names) of the slice, under both packages
SLICE = {
    "ops.filters": ["conv2d_same", "gaussian_kernel1d", "gaussian_blur",
                    "gaussian_blur_cv", "box_filter", "blur_mean", "sobel"],
    "ops.histogram": ["histogram256", "quantiles_bisect", "quantiles_u8",
                      "quantiles_approx", "percentile_stretch",
                      "_otsu_from_hist", "otsu_threshold",
                      "otsu_threshold_patchwise", "clahe", "equalize_hist"],
    "ops.denoise": ["nlm_denoise", "bilateral_filter"],
    "ops.morphology": ["ellipse_se", "dilate", "erode", "opening", "closing",
                       "reconstruction_by_dilation",
                       "binary_dilate", "binary_erode",
                       "binary_opening", "binary_closing",
                       "binary_close_open_packed",
                       "binary_reconstruction_by_dilation"],
    "ops.components": ["connected_components", "component_sizes",
                       "remove_small_objects", "remove_small_holes",
                       "clean_mask", "largest_component", "convex_hull_mask",
                       "mask_bbox"],
    "ops.skeleton": ["neighbor_count", "skeletonize", "prune_isolated",
                     "prune_endpoints"],
    "ops.orientation": ["compute_orientation_field"],
    "ops.geometry": ["rotate_points", "angle_diff", "orientation_diff",
                     "resize_bilinear", "upsample_bilinear_matmul",
                     "affine_warp"],
    "ops.gabor": ["gabor_kernel", "gabor_enhance",
                  "estimate_ridge_frequency_blockwise",
                  "gabor_enhance_blockfreq", "estimate_ridge_frequency"],
    "preprocessing.enhance": ["normalize_image", "denoise_image",
                              "segment_fingerprint", "binarize",
                              "smooth_fingerprint_skeleton",
                              "thinning_and_cleaning",
                              "preprocess_fingerprint"],
    "features.minutiae": ["crossing_number", "extract_minutiae",
                          "from_matrix"],
    "features.quality": ["postprocess_minutiae"],
    "matching.ransac": ["compute_descriptor_weights", "hypothesis_uniforms",
                        "sample_hypotheses", "anchor_promote",
                        "match_minutiae_pair", "match_pairs_batch",
                        "screen_promote_batch"],
    "matching.dataset": ["load_dataset", "genuine_pairs", "impostor_pairs"],
    "matching.runner": ["match_pair_indices", "_log_pair_scores",
                        "_write_genuine_stats", "main"],
    "utils.io": ["read_image_grayscale", "write_image", "minutiae_to_json",
                 "save_minutiae_json", "load_minutiae_matrix", "pad_minutiae"],
    "utils.logging": ["console_step", "get_file_logger"],
    "utils.padding": ["pad_to_multiple", "canonical_shape", "pad_image_batch"],
    "utils.native_loader": ["native_available", "batch_load",
                            "batch_load_u8"],
    "config.loader": ["load_yaml_config", "load_fingerprint_config",
                      "load_classifier_config", "load_matching_config",
                      "load_segmentation_config", "print_config_summary"],
    "catalog.parse": ["parse_filename", "user_id_from_filename"],
    "catalog.catalog": ["scan_cluster", "scan_dataset", "main"],
    "catalog.verify": ["check_id_consistency"],
    "evaluation.metrics": ["evaluate_frr_across_thresholds",
                           "evaluate_far_across_thresholds", "compute_eer",
                           "report_scores", "compute_minutiae_statistics"],
    "evaluation.roc": ["plot_roc"],
    "preprocessing.runner": ["_find_images", "_canonical_shape",
                             "run_preprocessing", "main"],
    "features.runner": ["_overlay", "process_directory", "main"],
    "pipeline": ["run_all"],
    "classifier.data": ["collect_image_paths", "extract_id", "global_id_for",
                        "FingerprintAugmentations", "two_view_batches",
                        "local_contrast_normalization",
                        "estimate_dominant_orientation", "preprocess_image"],
    "classifier.augment_device": ["augment_batch"],
    "models.losses": ["nt_xent_loss", "focal_tversky_loss", "dice_coeff",
                      "dice_loss", "iou_score", "bce_with_logits"],
    "train.schedule": ["cosine_warmup_schedule"],
    "train.ssl_train": ["create_ssl_train_step", "init_ssl_state",
                        "save_checkpoint", "load_checkpoint", "train_ssl",
                        "train_ssl_device"],
    "train.seg_train": ["collect_image_mask_paths", "_load_pair", "_augment",
                        "train_from_config"],
    "classifier.pipeline": ["build_model", "main"],
    "classifier.sorter": ["main"],
    "classifier.visualize": ["visualize_embeddings"],
    "preprocessing.visualize": ["visualize_orientation"],
    "clustering.kmeans": ["kmeans_plus_plus_init", "kmeans"],
    "clustering.pca": ["pca_reduce"],
    "clustering.agglomerative": ["agglomerative_fast"],
    "clustering.metrics": ["silhouette_score_cosine", "davies_bouldin_index",
                           "calinski_harabasz_index", "evaluate_clustering"],
    "preprocessing.segmentation_infer": ["load_model", "segment_images"],
    "utils.checkpoint": ["save_msgpack"],
    "parallel.mesh": ["create_mesh", "gallery_sharding", "replicated"],
    "parallel.gallery": ["shard_gallery", "pad_gallery", "all_pairs_scores",
                         "take_templates", "shard_pairs_scores",
                         "shard_pairs_screen", "unique_pairs",
                         "shard_blocks_screen", "all_pairs_unique",
                         "identify", "identify_batch"],
}
# Not listed: ``catalog.save_catalog`` takes the records ``scan_dataset``
# returns (a list of dicts) where the JAX package's takes a DataFrame, and
# so do the sorter's ``copy_files_to_clusters`` and ``compute_purity``
# (``rows``); ``classifier.extract_embeddings`` has no ``variables`` (the
# port's model holds its weights) and takes a ``seconds`` dict;
# ``utils.checkpoint.load_msgpack`` takes no template (``models.
# load_jax_variables`` holds the tree to the model);
# ``utils.profiling``'s ``stage_timer`` defaults to its own module's logger
# and ``device_trace`` writes a torch.profiler trace to its own directory.
# Functions the port keeps in another module: the matcher's batch entry
# points sit beside kernel D's wrapper.
PORT_MODULE = {
    ("matching.ransac", name): "matching.cuda_match"
    for name in ("match_minutiae_pair", "match_pairs_batch",
                 "screen_promote_batch")}
# The JAX package's kernel entry points and the port's functions named
# after them: same parameters and defaults, without ``interpret`` (a CPU
# tensor takes the plain twin). ``fill_holes_split`` is not listed: the JAX
# kernel is handed the border-connected background as packed planes, which
# the port's entry point computes no counterpart of.
KERNEL_ENTRY = {
    ("ops.pallas_kernels", "nlm_denoise_pallas_sym"):
        ("ops.denoise", "nlm_denoise_sym"),
    ("ops.pallas_kernels", "nlm_denoise_pallas_blocked"):
        ("ops.denoise", "nlm_denoise_blocked"),
    ("ops.pallas_kernels", "sauvola_binarize_pallas"):
        ("ops.cuda_binarize", "sauvola_binarize"),
    ("ops.pallas_kernels", "binarize_fused_pallas"):
        ("ops.cuda_binarize", "binarize_fused"),
    ("ops.pallas_kernels", "binarize_fused_split_pallas"):
        ("ops.cuda_binarize", "binarize_fused_split"),
    ("ops.pallas_bitpack", "open_erode_reconstruct_packed"):
        ("ops.cuda_morph", "open_erode_reconstruct"),
    ("ops.pallas_cc", "remove_small_split_pallas"):
        ("ops.cuda_cc", "remove_small_split"),
}
# Parameters the port drops, per function (every other function drops
# none): ``use_pallas``, since the port has one route and the tensor's
# device chooses the kernel or its twin.
DROPPED = {
    (module, name): {"use_pallas"}
    for module, names in (
        ("preprocessing.enhance", ["denoise_image", "binarize",
                                   "thinning_and_cleaning",
                                   "preprocess_fingerprint"]),
        ("matching.ransac", ["screen_promote_batch"]),
        ("parallel.gallery", ["shard_pairs_scores", "shard_pairs_screen",
                              "shard_blocks_screen", "all_pairs_unique",
                              "identify", "identify_batch"]))
    for name in names}
# Parameters only the port has: the device an entry point runs on, last.
ADDED = {"device"}


def _params(fn, drop=()):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()
            if p.name not in drop]


def _imports_in_a_fresh_process(modules) -> list:
    """The FORBIDDEN packages in ``sys.modules`` after importing
    ``modules`` in a new interpreter."""
    code = ("import importlib, sys\n"
            f"for m in {list(modules)!r}: importlib.import_module(m)\n"
            f"print([m for m in {FORBIDDEN!r} if m in sys.modules])")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return ast.literal_eval(res.stdout.strip().splitlines()[-1])


def test_port_imports_neither_jax_nor_cv2():
    """Every module of the port, imported together: none of FORBIDDEN."""
    assert _imports_in_a_fresh_process(PORT_MODULES) == []


def test_matcher_imports_neither_jax_cv2_pil_nor_the_jax_package():
    """The matcher, the gallery and the file pipeline run on a machine
    without JAX, matplotlib or the JAX package."""
    assert _imports_in_a_fresh_process(
        [f"{PORT_PKG}.matching.runner", f"{PORT_PKG}.parallel",
         f"{PORT_PKG}.pipeline",
         f"{PORT_PKG}.utils.io", f"{PORT_PKG}.evaluation"]) == []


def _imported_names(path: Path) -> set:
    """Top-level package names a source imports anywhere in it (function
    bodies included: those imports run only when called)."""
    import ast
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("module", PORT_MODULES)
def test_port_sources_import_nothing_forbidden(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    assert not _imported_names(path) & set(FORBIDDEN), module


RUNNER_SOURCES = ["preprocessing/runner.py", "features/runner.py",
                  "matching/runner.py", "pipeline.py", "utils/transfer.py"]


@pytest.mark.parametrize("module", RUNNER_SOURCES)
def test_runners_divide_no_tensor_by_a_python_scalar(module):
    """On CUDA, PyTorch turns a division by the Python scalar 255.0 into a
    multiplication by its reciprocal, one ulp off: the runners scale uint8
    to [0, 1] through ``bin_to_unit`` (a tensor divisor)."""
    src = (ROOT / PORT_PKG / module).read_text()
    for form in ("/ 255.0", "/ 255)", "/255", "/ 255\n"):
        assert form not in src, form


def _divisions_by_scalars(fn):
    """Python-scalar divisors of tensors that ``fn`` divides, other than
    powers of two (exact on every device)."""
    from torch.overrides import TorchFunctionMode
    found = []
    divs = {torch.Tensor.__truediv__, torch.Tensor.div, torch.div,
            torch.true_divide, torch.Tensor.__itruediv__, torch.Tensor.div_}

    class Watch(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in divs and len(args) > 1 and isinstance(
                    args[1], (int, float)):
                m, _ = math.frexp(float(args[1]))
                if abs(m) != 0.5:
                    found.append(args[1])
            return func(*args, **kwargs)

    with Watch():
        fn()
    return found


def _op_calls():
    """One call of each port op that divides, on small CPU tensors."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops import (
        gabor as TGb, geometry as TG, histogram as TH, morphology as TM)
    g = np.random.default_rng(10)
    x = torch.from_numpy(g.random((2, 64, 64), dtype=np.float32))
    o = (torch.from_numpy(g.random((2, 64, 64), dtype=np.float32)) - 0.5
         ) * math.pi
    m = x > 0.2
    fm = TGb.estimate_ridge_frequency_blockwise(x, mask=m)
    mat = np.array([[0.9, 0.1, 2.0], [-0.1, 0.9, -1.0]])
    return {
        "gabor_enhance": lambda: TGb.gabor_enhance(x, o, mask=m),
        "estimate_ridge_frequency_blockwise":
            lambda: TGb.estimate_ridge_frequency_blockwise(x, mask=m),
        "gabor_enhance_blockfreq":
            lambda: TGb.gabor_enhance_blockfreq(x, o, fm, mask=m),
        "estimate_ridge_frequency":
            lambda: TGb.estimate_ridge_frequency(x, o, mask=m),
        "bilateral_filter": lambda: denoise.bilateral_filter(x),
        "nlm_denoise_plain": lambda: denoise.nlm_denoise_plain(
            x[:, :16, :16], search_window=5),
        "resize_bilinear": lambda: TG.resize_bilinear(x, (40, 90)),
        "affine_warp": lambda: TG.affine_warp(x[0], mat),
        "angle_diff": lambda: TG.angle_diff(x, o),
        "equalize_hist": lambda: TH.equalize_hist(x),
        "reconstruction_by_dilation":
            lambda: TM.reconstruction_by_dilation(TM.erode(x, 5), x),
    }


@pytest.mark.parametrize("name", sorted(_op_calls()))
def test_ops_divide_no_tensor_by_a_python_scalar(name):
    """``ops/gabor.py``, ``ops/denoise.py`` and the other ops' divisions of
    a tensor take a tensor divisor (or a power of two), as the runners'
    do: watched as they run, not read from the source."""
    assert _divisions_by_scalars(_op_calls()[name]) == []


def test_the_division_watch_sees_a_scalar_division():
    assert _divisions_by_scalars(lambda: torch.ones(3) / 255.0) == [255.0]
    assert _divisions_by_scalars(lambda: torch.ones(3) / 4.0) == []


@pytest.mark.parametrize("entry", ["preprocessing.runner.run_preprocessing",
                                   "features.runner.process_directory",
                                   "matching.runner.main",
                                   "pipeline.run_all"])
def test_runners_default_to_the_card_and_raise_without_one(entry, tmp_path,
                                                          monkeypatch):
    """Entry points run on the card unless the caller asks for the CPU."""
    module, name = entry.rsplit(".", 1)
    fn = getattr(importlib.import_module(f"{PORT_PKG}.{module}"), name)
    assert inspect.signature(fn).parameters["device"].default is None
    assert list(inspect.signature(fn).parameters)[-1] == "device"
    if torch.cuda.is_available():
        return
    monkeypatch.chdir(tmp_path)
    kwargs = {"skip_ssl": True} if name == "run_all" else {}
    first = [str(tmp_path)] if name != "main" else []
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(*first, device=device, **kwargs)
    assert not any(tmp_path.iterdir())        # raised before any work


def _ssl_config(tmp_path) -> Path:
    """A classifier config over ``tmp_path`` (tiny model, no checkpoint)
    and a 2-image DBII tree."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.image_codec import (
        encode_png)
    d = tmp_path / "dataset" / "DBII"
    d.mkdir(parents=True)
    for name in ("1_1_1.png", "2_1_1.png"):
        (d / name).write_bytes(encode_png(np.full((96, 96), 90, np.uint8)))
    cfg = tmp_path / "classifier.yml"
    cfg.write_text(
        f"paths:\n  root_dir: {tmp_path}\n  dataset_dir: ./dataset\n"
        "  save_dir: ./save_models\n"
        "ssl:\n  dataset:\n    batch_size: 2\n    seed: 0\n    image_size: 64\n"
        "  model:\n    backbone: effnetv2_tiny\n    embedding_dim: 16\n"
        "    projection_hidden_dim: 16\n    projection_dim: 8\n"
        "  clustering:\n    n_clusters: 2\n    pca_dim: 0\n")
    return cfg


def test_run_all_sorts_into_the_dataset_dir(tmp_path, monkeypatch):
    """A fault of the JAX package's ``run_all`` the port does not copy: its
    SSL step reads the config's ``dataset_dir`` and its sorter writes the
    working directory's ``dataset/sorted_dataset``. The port's ``run_all`` reads
    ``<dataset_dir>/{DBII,Nist}``, sorts into ``<dataset_dir>/
    sorted_dataset`` (a directory outside the working directory here) and
    keeps its reports in the config's ``save_dir``."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.pipeline import run_all
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.image_codec import (
        encode_jpeg)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
        blob_prints)
    cfg = _ssl_config(tmp_path)          # its dataset_dir: tmp_path/dataset
    raw = tmp_path / "elsewhere"
    (raw / "DBII").mkdir(parents=True)
    for s, phase in ((1, 0.0), (1, 0.06), (2, 0.0), (2, 0.06)):
        img = blob_prints([10 + s], [phase], 320, 240)[0]
        (raw / "DBII" / f"{s}_{1 + int(phase > 0)}_1.jpg").write_bytes(
            encode_jpeg(np.round(img * 255.0).astype(np.uint8)))
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    res = run_all(str(raw), classifier_config=str(cfg), train=False,
                  device="cpu")
    assert res["ssl"]["num_images"] == 4 and res["id_consistency"]["ok"]
    sorted_names = sorted(p.name for p in (raw / "sorted_dataset").rglob("*.jpg"))
    assert sorted_names == sorted(p.name for p in (raw / "DBII").iterdir())
    assert res["catalog_rows"] == 4 == res["features"]["num_images"]
    save = tmp_path / "save_models"
    assert (save / "sorted_report.json").is_file()
    assert (save / "id_clusters.csv").is_file()
    # (the features runner's log goes to ./dataset/processed/minutiae, as
    # the JAX runner's does)
    assert not (work / "dataset" / "sorted_dataset").exists()
    assert not (work / "save_models").exists()
    assert set(res["seconds"]) >= {"ssl", "sorter", "catalog", "matching"}


@pytest.mark.parametrize("entry", [
    "classifier.pipeline.main", "classifier.sorter.main",
    "preprocessing.segmentation_infer.segment_images",
    "preprocessing.segmentation_infer.load_model", "entry.entry",
    "clustering.kmeans.kmeans_plus_plus_init", "clustering.kmeans.kmeans",
    "clustering.pca.pca_reduce", "clustering.agglomerative.agglomerative_fast",
    "clustering.metrics.silhouette_score_cosine",
    "clustering.metrics.davies_bouldin_index",
    "clustering.metrics.calinski_harabasz_index",
    "clustering.metrics.evaluate_clustering",
    "train.ssl_train.train_ssl", "train.ssl_train.train_ssl_device",
    "train.seg_train.train_from_config",
    "classifier.visualize.visualize_embeddings"])
def test_ssl_front_defaults_to_the_card_and_raises_without_one(
        entry, tmp_path, monkeypatch):
    """The SSL front's entry points run on the card unless the caller asks
    for the CPU: ``device`` is their last parameter, None by default, and
    without CUDA they raise before any work."""
    module, name = entry.rsplit(".", 1)
    fn = getattr(importlib.import_module(f"{PORT_PKG}.{module}"), name)
    params = inspect.signature(fn).parameters
    assert list(params)[-1] == "device" and params["device"].default is None
    if torch.cuda.is_available():
        return
    monkeypatch.chdir(tmp_path)
    cfg = _ssl_config(tmp_path)
    key, x, labels = (threefry.key(0), np.zeros((4, 2), np.float32),
                      np.zeros(4, np.int64))
    before = sorted(tmp_path.rglob("*"))
    args = {"classifier.pipeline.main": (str(cfg),),
            "classifier.sorter.main": (tmp_path / "none.csv",),
            "preprocessing.segmentation_infer.segment_images": (
                tmp_path, tmp_path / "out", tmp_path / "none.msgpack"),
            "preprocessing.segmentation_infer.load_model": (
                {}, tmp_path / "none.msgpack"),
            "entry.entry": (),
            "clustering.kmeans.kmeans_plus_plus_init": (key, x, 2),
            "clustering.kmeans.kmeans": (key, x, 2),
            "clustering.pca.pca_reduce": (x, 1),
            "clustering.agglomerative.agglomerative_fast": (key, x, 2),
            "clustering.metrics.silhouette_score_cosine": (x, labels, 2),
            "clustering.metrics.davies_bouldin_index": (x, labels, 2),
            "clustering.metrics.calinski_harabasz_index": (x, labels, 2),
            "clustering.metrics.evaluate_clustering": (x, labels, 2),
            "train.ssl_train.train_ssl": (None, lambda: iter([]), 1),
            "train.ssl_train.train_ssl_device": (
                None, np.zeros((2, 8, 8), np.uint8), 1),
            "train.seg_train.train_from_config": (str(cfg),),
            "classifier.visualize.visualize_embeddings": (
                x, labels, tmp_path / "fig" / "e.png")}[entry]
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(*args, device=device)
    assert sorted(tmp_path.rglob("*")) == before       # raised before any work


def test_resolve_device_is_the_only_route_to_the_cpu():
    """No module of the port but ``utils/device.py`` (and the profiler's
    trace helper, which only chooses what to trace) asks whether CUDA is
    there: nothing falls back to the CPU on its own."""
    asking = sorted(str(p.relative_to(ROOT / PORT_PKG))
                    for p in (ROOT / PORT_PKG).rglob("*.py")
                    if "cuda.is_available" in p.read_text())
    assert asking == ["utils/device.py", "utils/profiling.py"]


@pytest.mark.parametrize("module", sorted(SLICE))
def test_signatures_match_jax(module):
    jm = importlib.import_module(f"{JAX_PKG}.{module}")
    for name in SLICE[module]:
        tm = importlib.import_module(
            f"{PORT_PKG}.{PORT_MODULE.get((module, name), module)}")
        assert (_params(getattr(jm, name), DROPPED.get((module, name), ()))
                == _params(getattr(tm, name), ADDED)), f"{module}.{name}"


@pytest.mark.parametrize("jax_name", sorted(n for _, n in KERNEL_ENTRY))
def test_kernel_entry_points_match_jax(jax_name):
    (jmod, jname), (tmod, tname) = next(
        kv for kv in KERNEL_ENTRY.items() if kv[0][1] == jax_name)
    jfn = getattr(importlib.import_module(f"{JAX_PKG}.{jmod}"), jname)
    tfn = getattr(importlib.import_module(f"{PORT_PKG}.{tmod}"), tname)
    assert _params(jfn, {"interpret"}) == _params(tfn)


def test_named_tuples_match_jax():
    pairs = [("features.minutiae", "MinutiaeSet"),
             ("ops.orientation", "OrientationField"),
             ("preprocessing.enhance", "EnhancementResult"),
             ("matching.ransac", "MatchParams"),
             ("matching.ransac", "MatchResult"),
             ("matching.dataset", "MinutiaeDataset")]
    for module, name in pairs:
        jt = getattr(importlib.import_module(f"{JAX_PKG}.{module}"), name)
        tt = getattr(importlib.import_module(f"{PORT_PKG}.{module}"), name)
        assert jt._fields == tt._fields, name
        assert jt._field_defaults == tt._field_defaults, name


def test_minutiae_from_numpy_is_identity():
    """The templates handed to both packages: the JAX MinutiaeSet's numpy
    arrays become the port's MinutiaeSet with equal values and dtypes."""
    from multimodal_biometric_fingerprints_palms_tpu.features.minutiae import (
        MinutiaeSet as JSet)
    from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (
        minutiae_from_numpy)
    g = np.random.default_rng(3)
    ref = JSet(xy=g.uniform(0, 300, (2, 8, 2)).astype(np.float32),
               minutia_type=g.integers(0, 2, (2, 8)).astype(np.int32),
               orientation=g.normal(size=(2, 8)).astype(np.float32),
               quality=g.random((2, 8)).astype(np.float32),
               coherence=g.random((2, 8)).astype(np.float32),
               angular_stability=g.random((2, 8)).astype(np.float32),
               valid=g.random((2, 8)) < 0.7)
    got = minutiae_from_numpy(ref)
    assert got._fields == ref._fields
    for x, y in zip(got, ref):
        assert x.numpy().dtype == y.dtype
        np.testing.assert_array_equal(x.numpy(), y)
    assert minutiae_from_numpy(ref._asdict()).xy.equal(got.xy)


def test_kernel_sources_exist():
    assert build.SOURCES
    assert "match.cu" in build.SOURCES and "match" in build.LAUNCHES
    assert "mbfp_hypothesis_scores" in build._SIGNATURES
    for source, counter, entry in (
            ("nlm.cu", "nlm", "mbfp_nlm"),
            ("binarize.cu", "binarize", "mbfp_binarize_front"),
            ("morph.cu", "morph", "mbfp_open_erode_reconstruct")):
        assert source in build.SOURCES and counter in build.LAUNCHES
        assert entry in build._SIGNATURES
        assert f'extern "C" int {entry}(' in (
            build.CSRC_DIR / source).read_text()
    for name in build.SOURCES:
        assert (build.CSRC_DIR / name).is_file(), name
    # the build directory is git-ignored
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_kernel_d_reads_the_matchers_tensors():
    """Kernel D's entry point takes the matcher's own tensors (five fields
    per template side, four hypothesis tensors, two outputs): no staging
    launches before it. The kernel it replaced stays beside the tool that
    holds the two together, outside the package's build."""
    sig = build._SIGNATURES["mbfp_hypothesis_scores"]
    assert sig.count(build._P) == 17 and len(sig) == 26   # 16 tensors + stream
    src = (build.CSRC_DIR / "match.cu").read_text()
    assert 'extern "C" int mbfp_hypothesis_scores(' in src
    for word in ("rintf", "nearbyintf", "wgmma does not apply"):
        assert (word in src) == (word == "wgmma does not apply"), word
    parent = ROOT / "tools" / "match_parent.cu"
    assert "rintf" in parent.read_text()
    assert "match_parent.cu" not in build.SOURCES


def test_kernels_f_and_a_take_scratch_from_the_wrapper():
    """Kernel F's entry point takes the mean and std scratch planes beside
    the max-std words (one filtering pass, two device launches), kernel A's
    a byte LUT; the kernels they replaced stay beside the tool that holds
    each pair together, outside the package's build."""
    sig = build._SIGNATURES["mbfp_binarize_front"]
    assert sig.count(build._P) == 6 and len(sig) == 13
    src = (build.CSRC_DIR / "binarize.cu").read_text()
    assert "mean_std_kernel" in src and "__match_any_sync" not in src
    assert "uint8_t* lut" in (build.CSRC_DIR / "clahe.cu").read_text()
    for parent, word in (("binarize_parent.cu", "std_max_kernel"),
                         ("clahe_parent.cu", "float* lut")):
        assert word in (ROOT / "tools" / parent).read_text()
        assert parent not in build.SOURCES
    tool = (ROOT / "tools" / "binarize_clahe_variants.py").read_text()
    for old in re.findall(r'\("(constexpr [^"]+;)",', tool):
        assert old in src + (build.CSRC_DIR / "clahe.cu").read_text(), old


def test_thinning_wrapper_takes_large_and_ragged_frames():
    """Kernel C's wrapper keeps no frame limit: a frame whose two packed
    planes exceed one block's shared memory runs the device-memory form,
    with scratch the wrapper allocates at the size the library reports."""
    src = inspect.getsource(cuda_thin)
    assert not hasattr(cuda_thin, "_SMEM_LIMIT")
    for word in ("_SMEM_LIMIT", "232448", "must fit"):
        assert word not in src, word
    assert "mbfp_zs_thin_scratch" in src and "torch.empty(" in src
    cu = (build.CSRC_DIR / "thin.cu").read_text()
    assert "kSmemLimit = 232448" in cu and "__syncthreads_or" in cu
    for word in ("subpass_kernel", "pack_kernel", "store_kernel",
                 'extern "C" int mbfp_zs_thin_scratch(',
                 "cudaStreamSynchronize"):
        assert word in cu, word
    assert "kOwn" not in cu                 # the one-plane form is gone
    assert build._SIGNATURES["mbfp_zs_thin"].count(build._P) == 4
    params = inspect.signature(cuda_thin.zs_thin_cuda).parameters
    assert list(params)[:3] == list(
        inspect.signature(cuda_thin.zs_thin_plain).parameters)
    assert params["form"].default == "auto"
    m = torch.zeros((1, 2048, 1024), dtype=torch.bool, device="meta")
    for form in ("auto", "block", "device"):
        with pytest.raises(ValueError, match="CUDA tensor"):
            cuda_thin.zs_thin_cuda(m, form=form)


def test_kernel_g_takes_any_frame():
    """Kernel G holds no image in shared memory (a band of packed words a
    block, a fixed tile), runs no fixpoint loop, and its wrapper has no
    frame limit; its twin of the word algebra cuts bands and strips as the
    kernel does."""
    src = (build.CSRC_DIR / "morph.cu").read_text()
    for word in ("extern __shared__", "cudaFuncAttributeMaxDynamicSharedMemorySize",
                 "__syncthreads_or", "h * w"):
        assert word not in src, word
    assert '#include "packed_words.cuh"' in src
    assert not hasattr(cuda_morph, "_SMEM_LIMIT")
    assert "_SMEM_LIMIT" not in inspect.getsource(cuda_morph)
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kRows"]), int(consts["kWords"])) == (
        cuda_morph._ROWS, cuda_morph._WORDS)


def test_kernel_g_parent_stays_outside_the_build():
    """The kernel G replaced stays beside the tool that holds the two
    together, outside the package's build, and every text substitution of
    the tool's variants still finds its line in the shipped source."""
    parent = (ROOT / "tools" / "morph_parent.cu").read_text()
    assert "__syncthreads_or" in parent and "extern __shared__" in parent
    assert "morph_parent.cu" not in build.SOURCES
    src = (build.CSRC_DIR / "morph.cu").read_text()
    tool = (ROOT / "tools" / "morph_variants.py").read_text()
    subs = re.findall(r'\("(constexpr [^"]+;)",', tool)
    assert subs
    for old in subs:
        assert old in src, old


def test_kernel_headers_are_part_of_the_library_hash(tmp_path, monkeypatch):
    """Every header a source includes is hashed, so editing it rebuilds."""
    included = set()
    for name in build.SOURCES:
        included.update(re.findall(r'#include "([^"]+)"',
                                   (build.CSRC_DIR / name).read_text()))
    assert included == set(build.HEADERS)
    for name in build.SOURCES + build.HEADERS:
        (tmp_path / name).write_bytes((build.CSRC_DIR / name).read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = build._digest()
    header = tmp_path / build.HEADERS[0]
    header.write_text(header.read_text() + "\n")
    assert build._digest() != before


def test_launch_counters_untouched_on_cpu():
    before = dict(build.LAUNCHES)
    m = torch.from_numpy(np.random.default_rng(0).random((1, 16, 16)) < 0.5)
    cuda_cc.cc_filter(m, "clean", 1, min_size=3, max_size=3)
    cuda_thin.zs_thin(m)
    cuda_kernels.clahe(m.float(), 2.0, 8)
    denoise.nlm_denoise(m.float(), search_window=5)
    cuda_binarize.sauvola_binarize(m.float(), win=5)
    cuda_binarize.binarize_fused_split(torch.rand((1, 32, 32)))
    cuda_morph.open_erode_reconstruct(m)
    assert build.LAUNCHES == before


@pytest.mark.parametrize("call", [
    lambda t: cuda_kernels.clahe(t.float(), 2.0, 8),
    lambda t: cuda_cc.cc_filter(t, "largest", 2),
    lambda t: cuda_cc.cc_label(t, 2),
    lambda t: cuda_thin.zs_thin(t),
    lambda t: denoise.nlm_denoise(t.float()),
    lambda t: cuda_nlm.nlm_denoise_cuda(t.float()),
    lambda t: denoise.nlm_denoise_sym(t.float()),
    lambda t: denoise.nlm_denoise_blocked(t.float(), precision="f32"),
    lambda t: cuda_binarize.binarize_foreground(t.float()),
    lambda t: cuda_binarize.sauvola_binarize(t.float()),
    lambda t: cuda_morph.open_erode_reconstruct(t),
    lambda t: cuda_cc.fill_holes_split(t, 5),
    lambda t: cuda_cc.remove_small_split(t, 5),
])
def test_wrappers_raise_off_cpu_without_cuda(call):
    """A tensor that is not on the CPU never takes the plain path."""
    t = torch.zeros((1, 16, 16), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(t)


def test_load_dataset_defaults_to_the_card_and_raises_without_one(tmp_path):
    """Entry points run on the card unless the caller asks for the CPU."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.dataset import (
        load_dataset)
    assert inspect.signature(load_dataset).parameters["device"].default is None
    if torch.cuda.is_available():
        assert load_dataset(tmp_path).stacked.xy.device.type == "cuda"
    else:
        for device in (None, "cuda"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                load_dataset(tmp_path, device=device)
    assert load_dataset(tmp_path, device="cpu").stacked.xy.shape == (0, 64, 2)


def _hypothesis_args(device, pnum=2, k=16, h=8):
    from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (
        MinutiaeSet)
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=device)
    ms = MinutiaeSet(z(pnum, k, 2), z(pnum, k, dt=torch.int32), z(pnum, k),
                     z(pnum, k), z(pnum, k), z(pnum, k),
                     z(pnum, k, dt=torch.bool))
    return (ms, ms, z(pnum, k), z(pnum, k), z(pnum, h), z(pnum, h, 2),
            z(pnum, h), z(pnum))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_hypothesis_scores_cuda_refuses_other_devices(device):
    """Kernel D's wrapper raises on a CPU or any other non-CUDA tensor, and
    the dispatcher gives only a CPU tensor to the plain twin."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching import (
        cuda_match)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.ransac import (
        MatchParams)
    args = _hypothesis_args(device)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_match.hypothesis_scores_cuda(*args, MatchParams())
    before = dict(build.LAUNCHES)
    if device == "cpu":
        s, c = cuda_match.hypothesis_scores(*args, MatchParams())
        assert s.shape == c.shape == (2, 8) and c.dtype == torch.int32
    else:
        with pytest.raises(ValueError, match="CUDA tensor"):
            cuda_match.hypothesis_scores(*args, MatchParams())
    assert build.LAUNCHES == before


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "tools/port_output_digest.py",
                                    "tools/nlm_variants.py",
                                    "tools/match_variants.py",
                                    "tools/binarize_clahe_variants.py",
                                    "tools/morph_variants.py",
                                    "tools/matcher_rate.py",
                                    "tools/polyu_set.py",
                                    "tools/gabor_eer_port.py",
                                    "tools/ssl_front_port.py",
                                    "tools/ssl_train_port.py"])
def test_card_scripts_import_nothing_of_the_jax_side(script):
    """The scripts that run on the card's machine import neither JAX, the
    JAX package nor the root ``bench.py`` (the JAX benchmark): the port has
    its own copy of the synthetic inputs (``utils/synthetic.py``)."""
    names = _imported_names(ROOT / script)
    assert not names & {"bench", *FORBIDDEN}, names


def test_synthetic_module_needs_numpy_only():
    code = ("import sys; import {0}.utils.synthetic; "
            "bad = [m for m in ('jax', 'torch', 'cv2', 'bench') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)"
            ).format(PORT_PKG)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
