"""The cluster CLI (``python -m ray_tpu_torch``)."""
