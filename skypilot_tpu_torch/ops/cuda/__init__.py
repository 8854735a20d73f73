"""Hand-written Hopper kernels (sources under skypilot_tpu_torch/csrc/),
each beside its plain PyTorch version; the counterpart of ops/pallas/."""
