"""aule_tpu_torch: the PyTorch / CUDA (H100) port of aule_tpu.

The JAX package `aule_tpu` stays the reference; this package mirrors its
layout (`ops/`, `models/`, `serving/`, `utils/`) so each module's
counterpart is found by path.  It imports torch and numpy only.

Entry points (`ServingEngine`, `llama.init_params`, `llama.load_jax_params`)
run on the card by default and raise `RuntimeError` when CUDA is absent;
pass `device="cpu"` to run the plain PyTorch versions of the kernels.
The op wrappers follow their tensors: a CPU tensor takes the plain
version, a CUDA tensor launches the hand-written kernel (csrc/) or raises.
"""

__version__ = "0.1.0"
