"""parallel of the PyTorch / CUDA port (mirrors aule_tpu/parallel): meshes
over torch.distributed, the cross-rank softmax combine and the
differentiable collectives under it, head / context / ring / Ulysses
attention and the sharded paged decode, AdamW with its ZeRO-1 layout,
and pipeline parallelism (`parallel.pipeline`, imported from there as
JAX's package does)."""

from .collectives import (  # noqa: F401
    softmax_combine_allreduce,
    softmax_combine_pair,
)
from .mesh import make_mesh  # noqa: F401
from .optimizer import (  # noqa: F401
    AdamWState,
    adamw_init,
    global_norm,
    make_adamw_train_step,
    zero1_specs,
)
from .sharded import (  # noqa: F401
    make_context_parallel_attention,
    make_head_parallel_attention,
    make_ring_attention,
    make_sharded_paged_attention,
    make_sharded_paged_attention_fused,
    make_ulysses_attention,
)

__all__ = [
    "softmax_combine_allreduce",
    "softmax_combine_pair",
    "make_mesh",
    "AdamWState",
    "adamw_init",
    "make_adamw_train_step",
    "zero1_specs",
    "make_context_parallel_attention",
    "make_head_parallel_attention",
    "make_ring_attention",
    "make_sharded_paged_attention",
    "make_sharded_paged_attention_fused",
    "make_ulysses_attention",
    "global_norm",
]
