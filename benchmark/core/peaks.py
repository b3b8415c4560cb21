"""Published peaks by card name: dense bf16 tensor-core operations a second
and HBM bytes a second.  NVIDIA's H100 SXM data sheet, without sparsity,
at the full 700 W power limit (a card set below it runs slower under load;
the harness prints the limit beside every share of these peaks)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def for_card(kind):
    """The card's peaks, or None for a card the table does not hold."""
    return PEAKS.get(kind)
