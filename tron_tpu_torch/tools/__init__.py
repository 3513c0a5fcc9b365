"""Command-line tools of the port (counterpart of `tron_tpu/tools/` and `scripts/`)."""
