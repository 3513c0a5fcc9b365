"""Operators (counterpart of `tron_tpu/ops/`): gridding, degridding, FFT
chain, coil combine."""
