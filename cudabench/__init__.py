"""The benchmark of the PyTorch/CUDA port (``cudabench/README.md``)."""
