"""Facts of the card a run measures on."""

from __future__ import annotations

import subprocess
from typing import Dict

QUERY = ("name", "power.limit", "clocks.sm", "clocks.max.sm",
         "temperature.gpu", "power.draw")


def smi_facts() -> Dict[str, str]:
    """What `nvidia-smi` reads of each card: {index: "name, power.limit,
    ..."}, or {"error": why} where it cannot run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=" + ",".join(QUERY),
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=30,
        ).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return {"error": str(exc)}
    return {str(i): line.strip()
            for i, line in enumerate(out.strip().splitlines())}
