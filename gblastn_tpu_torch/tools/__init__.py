"""The port's profilers: counterparts of the JAX package's ``tools/prof_*``.

Each runs on the card (``--device cuda``, the default; an error without
one) and, for the tests, at a small size on the CPU
(``--device cpu --small``), where its times are the CPU's and no device
measurement:

    python -m gblastn_tpu_torch.tools.prof_scan_parts   # scan parts, P1-P3
    python -m gblastn_tpu_torch.tools.prof_scan_rate    # scan stages, Gbases/s
    python -m gblastn_tpu_torch.tools.prof_gapped       # K2 alone [--parity]
    python -m gblastn_tpu_torch.tools.prof_e2e config1  # search() stage report

``timing`` holds the two-depth loop timer they share, and ``workloads``
the synthetic genomes and reads (bench.py's recipe and
prof_scan_rate's), which ``chip_smoke.py`` uses too.
"""
