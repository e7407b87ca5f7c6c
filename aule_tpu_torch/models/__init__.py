"""models of the PyTorch / CUDA port (mirrors aule_tpu/models)."""
