"""Walkthroughs of the port, each runnable with `python -m`
(counterparts of the JAX package's examples/): `serve_demo` (the serving
engine's features at once) and `train_demo` (dp x tp ZeRO-1 training with
a checkpoint round trip)."""
