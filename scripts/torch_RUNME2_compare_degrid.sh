#!/bin/sh
# Cross-implementation recon comparison on the PyTorch/CUDA port:
# scripts/RUNME2_compare_degrid.sh on tron_tpu_torch (reference
# src/RUNME2_others_degrid_phantom.m).  The exact-DTFT oracle plays the
# gold-standard role; the plain torch gridder and the CUDA kernel are
# compared with it, NMSE/SSIM tables to CSV and difference figures to
# $TRON_OUT (default output/torch).  Runs on CUDA device 0.
set -e
cd "$(dirname "$0")/.."
OUT=${TRON_OUT:-output/torch}
mkdir -p "$OUT"
python -m tron_tpu_torch.tools.compare_recon --n 64 --npe 128 --out "$OUT"
python -m tron_tpu_torch.tools.compare_recon --n 64 --npe 128 --golden --out "$OUT"
echo done
