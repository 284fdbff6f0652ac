"""Published peaks of the card the cells run on (NVIDIA's H100 SXM data
sheet; the H100 80GB HBM3 is the SXM part), at its full 700 W limit."""

HBM_BYTES_PER_S = 3.35e12
