#!/bin/bash
# What a GPU machine offers the port: Python packages, libjpeg for the
# native loader, CUDA's nvJPEG, the build tools, the card. Run from the root
# of a checkout:
#   bash tools/card_inventory.sh
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
for m in cv2 PIL yaml pandas matplotlib torchvision numpy scipy triton; do
  python3 -c "import $m; print('$m', getattr($m, '__version__', '?'))" 2>&1 | tail -1
done
ldd native/libmbfp_loader.so 2>&1 | grep -i -E 'jpeg|not found'
ls /usr/local/cuda/lib64/ | grep -i jpeg
ls /usr/include/jpeglib.h /usr/include/x86_64-linux-gnu/jpeglib.h 2>&1
python3 -c 'import ctypes.util as u; print("find_library jpeg:", u.find_library("jpeg"))'
which g++ make
tmp=$(mktemp -d)
cp native/Makefile native/batch_loader.cpp "$tmp"/
make -C "$tmp" 2>&1 | tail -2
rm -rf "$tmp"
nproc
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
