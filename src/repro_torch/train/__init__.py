"""Training substrate, ported from ``src/repro/train/``: optimizers and
schedules over nested dicts of tensors, the train step, step-atomic
checkpoints in the JAX package's format, and the fault-tolerant loop."""
