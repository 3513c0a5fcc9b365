"""The benchmark of tron_tpu_torch (see README.md)."""
