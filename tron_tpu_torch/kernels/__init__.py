"""Kernel math (counterpart of `tron_tpu/kernels/`)."""
