"""Published peaks of the cards the benchmark runs on (NVIDIA's H100 SXM
data sheet: dense rates, no sparsity, at the full 700 W power limit)."""

H100_SXM = {'bf16_flops': 989e12, 'f32_flops': 67e12, 'hbm_bytes': 3.35e12}
PEAKS = {'NVIDIA H100 80GB HBM3': H100_SXM}


def for_device(name):
    """The peaks of the card ``torch.cuda.get_device_name()`` names, or None
    for a card (or the CPU) the table does not hold."""
    return PEAKS.get(name)
