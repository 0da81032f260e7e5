"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense rates, at the
full 700 W power limit (NVIDIA's data sheet).  A card set to a lower limit
runs slower under load; runs report the card's name beside every number."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # outside the tensor cores
