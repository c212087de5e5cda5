"""PyTorch/CUDA port of the fingerprint biometric framework.

Sits beside ``multimodal_biometric_fingerprints_palms_tpu`` (the JAX
reference) and keeps its module layout and function names. Plain tensor
code is ordinary PyTorch on an explicit device; the Pallas kernels of the
JAX package become hand-written CUDA kernels for Hopper (``csrc/``), built
at first use by ``kernels.build``. A kernel wrapper given a CPU tensor runs
its plain PyTorch twin; given a CUDA tensor it launches the kernel.

Public layouts match the JAX package: images (..., H, W) float32 in [0, 1],
masks bool, ``MinutiaeSet`` a NamedTuple of tensors.

Ported so far: the enhance + extract chain (``preprocess_fingerprint`` ->
``extract_minutiae`` -> ``postprocess_minutiae``) in the configuration the
JAX package runs with ``use_pallas=False``; the 1:1 RANSAC matcher
(``matching.runner.match_pair_indices``, with and without the cascade
screen) on the JAX package's accelerator route; and the file pipeline from
images on disk to FRR/FAR/EER (``catalog``, ``preprocessing.runner``,
``features.runner``, ``matching.runner.main``,
``pipeline.run_all(skip_ssl=True)``) with the port's own image codec, YAML
reader and CSV writer (``utils.image_codec``, ``config``); the gallery; and
the SSL front, serving only: the SSL model and UNet++ (``models``),
clustering, the SSL pipeline and sorter (``classifier``), segmentation
inference and ``pipeline.run_all(skip_ssl=False, train=False)``, over the
JAX package's flax msgpack checkpoints (``utils.checkpoint``). Entry points
run on the card unless given ``device="cpu"``.
"""

__version__ = "0.1.0"
