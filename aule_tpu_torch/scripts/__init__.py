"""The port's scripts, each runnable with `python -m`
(counterparts of the JAX package's scripts/): `scaling_report` (serving
tokens/s at 1..N engine replicas) and `multihost_worker` (a worker of
entry.dryrun_multihost)."""
