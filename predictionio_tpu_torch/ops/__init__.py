"""Device ops: ALS training and model, the batched solvers, top-k
serving plans, the fused top-k kernel."""
