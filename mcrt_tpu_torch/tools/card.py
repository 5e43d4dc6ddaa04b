"""The card's name and power limit, to print beside every time measured on
it: a card set below its maximum power runs slower under load."""
from __future__ import annotations

import subprocess


def card_line() -> str:
    """``name, power.limit`` of the first card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
