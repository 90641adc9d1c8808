"""What a run's numbers may depend on besides the code: the card's name,
power limit, SM clock and temperature, and the host's CPU, cores and
load. Read before and after the measured window, never inside it."""

from __future__ import annotations

import os
import platform
import subprocess
from typing import Dict

QUERY = "name,power.limit,clocks.sm,temperature.gpu,power.draw"


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={QUERY}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else \
            "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def host() -> Dict[str, object]:
    model = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "Hardware", "CPU part"):
                    model += " " + line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return {"cpu": model, "cpu_count": os.cpu_count(),
            "loadavg": list(os.getloadavg())}


def record() -> Dict[str, object]:
    """The card's line (``QUERY``'s fields) and the host's state."""
    return {"card": card(), **host()}
