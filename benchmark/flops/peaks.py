"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W limit)."""

PEAK_OPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
PEAK_HBM_BYTES = 3.35e12
