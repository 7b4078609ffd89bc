"""Device ops: top-k serving plans, the fused top-k kernel, ALS model."""
