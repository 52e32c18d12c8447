"""Training, ported from the JAX package's ``repro.training``: AdamW with
its schedules, the synthetic data pipeline, checkpoints in the reference's
format and the fault-tolerant train loop."""
