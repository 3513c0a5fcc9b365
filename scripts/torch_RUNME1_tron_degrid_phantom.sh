#!/bin/sh
# Synthesize radial data from the Shepp-Logan phantom with the forward
# (degrid) op of the PyTorch/CUDA port: scripts/RUNME1_tron_degrid_phantom.sh
# on tron_tpu_torch (reference src/RUNME1_tron_degrid_phantom.sh).  Runs on
# CUDA device 0; files go to $TRON_OUT (default output/torch).
set -e
cd "$(dirname "$0")/.."
OUT=${TRON_OUT:-output/torch}
mkdir -p "$OUT"
# generate the phantom fixture (the reference ships it via git-lfs)
python -m tron_tpu_torch.tools.make_phantom "$OUT/shepplogan.ra" --n 256
python -m tron_tpu_torch.cli "$OUT/shepplogan.ra" "$OUT/sl_data_tron.ra"
echo "wrote $OUT/sl_data_tron.ra"
