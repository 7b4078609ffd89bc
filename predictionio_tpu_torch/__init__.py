"""predictionio_tpu_torch: the PyTorch/CUDA port of predictionio_tpu.

A second package beside the JAX one, held against it by parity tests.
It imports torch and numpy, never jax and never predictionio_tpu. Entry
points run on CUDA unless the caller passes `device="cpu"`; each kernel
the JAX package wrote in Pallas is a hand-written Hopper kernel under
`csrc/`, built with nvcc at first use.

Ported so far: every template's lifecycle (app new -> import -> train
-> deploy over the MEM, SQLITE, EVLOG and PEVLOG stores), training,
serving (/queries.json through the fused top-k kernel, on the selector
wire with /metrics, deadlines, shedding, /reload and /stop), the REST
event server, eval, batchpredict, and the streaming fold-in that keeps
a deployment fresh (streaming.Refresher). See ROADMAP.md.
"""

__version__ = "0.1.0"
