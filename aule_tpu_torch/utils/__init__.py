"""utils of the PyTorch / CUDA port (mirrors aule_tpu/utils)."""
