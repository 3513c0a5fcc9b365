#!/bin/sh
# Adjoint (gridding) reconstructions on the PyTorch/CUDA port, timed 3x
# each: scripts/RUNME3_tron_grid_all.sh on tron_tpu_torch (reference
# src/RUNME3_tron_grid_all.sh).  The reference's git-lfs datasets are not
# shipped; synthetic stand-ins with the same geometry are generated first.
# Runs on CUDA device 0; files go to $TRON_OUT (default output/torch);
# TRON_FULLSCALE=0 leaves out the full-scale whole-body section.
set -e
cd "$(dirname "$0")/.."
OUT=${TRON_OUT:-output/torch}
mkdir -p "$OUT"

timed() {
  t0=$(date +%s.%N)
  "$@"
  t1=$(date +%s.%N)
  echo "elapsed: $(echo "$t1 $t0" | awk '{printf "%.2f s", $1-$2}')  [$*]"
}

# phantom data from RUNME1
[ -f "$OUT/sl_data_tron.ra" ] || sh scripts/torch_RUNME1_tron_degrid_phantom.sh

# 1) linear-angle phantom gridding (reference: tron -a -d 512).
#    --scheme linear_half matches the convention RUNME1's degrid used
#    (the reference's grid/degrid linear conventions differ; SURVEY.md §7)
for i in 1 2 3; do
  timed python -m tron_tpu_torch.cli -a -d 512 --scheme linear_half \
    "$OUT/sl_data_tron.ra" "$OUT/sl_img_tron.ra"
done

# 2) golden-angle multicoil dynamic series (whole-body analog, reduced):
#    reference: tron -a -G -u 0.4 -d 21 ex_whole_body.ra
[ -f "$OUT/ga_multicoil.ra" ] || \
  python -m tron_tpu_torch.tools.make_goldenangle "$OUT/ga_multicoil.ra" --nc 6 --nro 512 --npe 1479
for i in 1 2 3; do
  timed python -m tron_tpu_torch.cli -a -G -u 0.4 -d 21 "$OUT/ga_multicoil.ra" "$OUT/ga_img_tron.ra"
done

# 3) FULL reference-scale whole-body (6 x 512 x 20,271 = 498 MB, 956 frames
#    of 256^2: the 3.28 s CUDA headline, src/RUNME3:10) streamed from disk.
if [ "${TRON_FULLSCALE:-1}" != "0" ]; then
  [ -f "$OUT/ex_whole_body.ra" ] || \
    python -m tron_tpu_torch.tools.make_goldenangle "$OUT/ex_whole_body.ra" \
      --nc 6 --nro 512 --npe 20271
  for i in 1 2 3; do
    timed python -m tron_tpu_torch.cli -a -G -u 0.4 -d 21 -v --stream \
      "$OUT/ex_whole_body.ra" "$OUT/img_cmt_tron.ra"
  done
  python -m tron_tpu_torch.tools.dataset_metrics "$OUT/img_cmt_tron.ra" \
    --data "$OUT/ex_whole_body.ra" --nc 6 -G -u 0.4 -d 21 --frames 0,400,-1 \
    --label whole_body --oracle --csv "$OUT/dataset_metrics.csv"

  # fp16-pair input variant: halves the acquisition bytes read from disk
  [ -f "$OUT/ex_whole_body_f16.ra" ] || \
    python -m tron_tpu_torch.tools.ra_tool half \
      "$OUT/ex_whole_body.ra" "$OUT/ex_whole_body_f16.ra"
  for i in 1 2 3; do
    timed python -m tron_tpu_torch.cli -a -G -u 0.4 -d 21 -v --stream --half \
      "$OUT/ex_whole_body_f16.ra" "$OUT/img_cmt_tron_f16.ra"
  done
fi

# 4) optic-nerve-class series (reference: tron -u 0.5 -a -G, RUNME3:16-18;
#    non-overlapping 128-profile frames)
[ -f "$OUT/optic_nerve.ra" ] || \
  python -m tron_tpu_torch.tools.make_goldenangle "$OUT/optic_nerve.ra" \
    --nc 4 --nro 256 --npe 2176
for i in 1 2 3; do
  timed python -m tron_tpu_torch.cli -a -G -u 0.5 "$OUT/optic_nerve.ra" "$OUT/img_on_tron.ra"
done
python -m tron_tpu_torch.tools.dataset_metrics "$OUT/img_on_tron.ra" \
  --data "$OUT/optic_nerve.ra" --nc 4 -G -u 0.5 --frames 0,-1 --label optic_nerve \
  --csv "$OUT/dataset_metrics.csv"

# 5) swallowing-class series (reference: tron -u 0.5 -d 21 -a -G,
#    RUNME3:20-22; 21-profile sliding window)
[ -f "$OUT/swallowing.ra" ] || \
  python -m tron_tpu_torch.tools.make_goldenangle "$OUT/swallowing.ra" \
    --nc 4 --nro 256 --npe 3000
for i in 1 2 3; do
  timed python -m tron_tpu_torch.cli -a -G -u 0.5 -d 21 "$OUT/swallowing.ra" "$OUT/img_sw_tron.ra"
done
python -m tron_tpu_torch.tools.dataset_metrics "$OUT/img_sw_tron.ra" \
  --data "$OUT/swallowing.ra" --nc 4 -G -u 0.5 -d 21 --frames 0,60,-1 --label swallowing \
  --csv "$OUT/dataset_metrics.csv"
echo done
