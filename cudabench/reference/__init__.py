"""The plain reference that decides ``correct``.

Plain PyTorch and NumPy, importing nothing of the program: ``plain/`` is a
frozen copy of the port's plain routes (its CPU twins of every kernel, the
enhancement chain, the features layer and the RANSAC matcher), with the
CUDA wrappers removed, so that a later change to the program cannot move
the reference. It runs on the device it is given, after the program's
state is freed, in blocks that bound its memory.

- ``enrol``: frames to masks, skeletons and templates;
- ``match``: identification scores and the all-pairs cascade's scores;
- ``compare``: the numbers each cell's limits hold.

Each entry takes ``lowp``: the control, the reference computed in the
nearest precision below the configuration's float32 that acts on it
(bfloat16: the chain's stage images, orientation field and templates; the
matcher's coordinates and distances). TF32, the step below float32 with
TF32 off, acts on nothing here: neither path has a matmul or a cuDNN
convolution. The control runs in ``calibrate.py`` and the control tests.
"""
