"""The published peaks of the card the benchmark states its shares against.

Frozen copy of CHIP_SPECS / CARD_NAMES / card_line of
hunyuanworld_mirror_tpu_torch/utils/profiling.py at commit
e2e15df8eb5b1f9149d8000ecb6c575b37fbec06: NVIDIA's H100 SXM data sheet,
dense rates without sparsity, at a power limit of 700 W. A card set below
that limit runs slower under load, so every run prints its limit beside
the peaks.
"""

import subprocess
from typing import NamedTuple


class ChipSpec(NamedTuple):
    name: str
    peak_flops_bf16: float
    peak_flops_f32: float
    hbm_bytes_per_s: float
    power_limit_w: float


H100 = ChipSpec("h100", 989e12, 67e12, 3.35e12, 700.0)

# torch.cuda.get_device_name -> spec (the SXM part only: the PCIe and NVL
# parts have other peaks)
CARD_NAMES = {"NVIDIA H100 80GB HBM3": H100}


def card_line() -> str:
    """The first card's `name, power.limit` as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def spec_for(card_name: str) -> ChipSpec:
    """The peaks of a card by torch.cuda.get_device_name; raises for a card
    the table does not hold, so no share is stated against another chip."""
    if card_name not in CARD_NAMES:
        raise RuntimeError(f"no peak rates for {card_name!r}; the table holds "
                           f"{sorted(CARD_NAMES)}")
    return CARD_NAMES[card_name]
