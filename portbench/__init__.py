"""The benchmark of arnerf_tpu_torch (README.md beside this file)."""
