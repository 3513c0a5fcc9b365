"""Operators (counterpart of `tron_tpu/ops/`): gridding, FFT chain, coil
combine."""
