"""serving of the PyTorch / CUDA port (mirrors aule_tpu/serving)."""
