"""parallel of the PyTorch / CUDA port (mirrors aule_tpu/parallel): the
single-device AdamW so far; meshes, collectives, ZeRO-1 and pipelines come
with the parallel-layer slice."""

from .optimizer import (  # noqa: F401
    AdamWState,
    adamw_init,
    global_norm,
    make_adamw_train_step,
)

__all__ = ["AdamWState", "adamw_init", "global_norm", "make_adamw_train_step"]
