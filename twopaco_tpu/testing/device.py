"""The card a measurement runs on, as nvidia-smi names it.

Every time the smoke test and the benchmark print carries this label:
a card may be set below its maximum power and then runs slower under
load, so a time is only comparable beside the card's name and limit.
"""

from __future__ import annotations

import subprocess


def card_labels() -> list[str]:
    """nvidia-smi's `name, power.limit` line for each card; raises
    RuntimeError when there is no nvidia-smi or it fails."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except FileNotFoundError:
        raise RuntimeError("nvidia-smi not found") from None
    lines = [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    if r.returncode != 0 or not lines:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return lines
