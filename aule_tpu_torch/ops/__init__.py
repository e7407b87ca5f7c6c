"""ops of the PyTorch / CUDA port (mirrors aule_tpu/ops)."""
