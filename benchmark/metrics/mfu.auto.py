"""The autoencoder steps' required work at the published peaks
(flops/autoencoder.py: the frozen forward's convolutions at TF32, its GCN
and the encoder's at bf16, the MLPs, the decoder and K1's operations at
float32, the sampler and K2 at HBM speed), as a share of the window's
time, %."""

from benchmark.metrics import least_time_share as read  # noqa: F401
