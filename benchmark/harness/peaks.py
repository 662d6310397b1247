"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
full 700 W power limit)."""

H100 = {
    "hbm_bytes_per_s": 3.35e12,     # HBM3, 80 GB
}
