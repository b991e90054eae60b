"""The benchmark of risc0_tpu_torch on NVIDIA cards: cells, configurations,
traffic mixes and per-layer metrics as files, found by name."""
