"""Runnable examples of the port: ``python -m
hnsw_itu_tpu_torch.examples.point3d`` and ``.custom_metric``."""
