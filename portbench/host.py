"""What the host was doing while a run ran: the process's age, the cards'
clocks and power (``nvidia-smi``), and the busy share of every other
process.  The run is placed where the operating system puts it; nothing
here binds it or starts it again.

Nothing here imports torch, and nothing runs at import time.
"""

from __future__ import annotations

import os
import resource
import shutil
import subprocess
import time
from typing import Dict, List

_SMI_FIELDS = ("index", "pci.bus_id", "name", "power.limit", "clocks.sm",
               "clocks.mem", "power.draw", "temperature.gpu")


def exec_seconds() -> float:
    """Seconds since the process started (``/proc/self/stat``)."""
    with open("/proc/self/stat") as fh:
        start = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        up = float(fh.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


class Cards:
    """``nvidia-smi``'s reading of every card, started at once and waited
    for in ``read``, so that the set-up does not wait on it (empty where
    it fails)."""

    def __init__(self) -> None:
        smi = shutil.which("nvidia-smi")
        self.proc = None
        if smi is not None:
            try:
                self.proc = subprocess.Popen(
                    [smi, f"--query-gpu={','.join(_SMI_FIELDS)}",
                     "--format=csv,noheader,nounits"],
                    stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                    text=True)
            except OSError:
                pass

    def read(self) -> List[Dict[str, str]]:
        if self.proc is None:
            return []
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.communicate()
            return []
        if self.proc.returncode != 0:
            return []
        return [dict(zip(_SMI_FIELDS, (f.strip() for f in line.split(","))))
                for line in out.splitlines() if line.strip()]


class HostWatch:
    """What the host did over a span: the busy share of every other
    process (``/proc/stat`` less this process's own CPU time), this
    process's CPU seconds and involuntary context switches, the load
    average at the end."""

    def __init__(self) -> None:
        self.t0 = time.perf_counter()
        self.stat0 = _proc_stat()
        self.ru0 = resource.getrusage(resource.RUSAGE_SELF)

    def read(self) -> dict:
        wall = time.perf_counter() - self.t0
        busy0, total0 = self.stat0
        busy1, total1 = _proc_stat()
        ru = resource.getrusage(resource.RUSAGE_SELF)
        own = (ru.ru_utime - self.ru0.ru_utime
               + ru.ru_stime - self.ru0.ru_stime)
        tick = os.sysconf("SC_CLK_TCK")
        ncpu = os.cpu_count() or 1
        others = ((busy1 - busy0) / tick - own) / max(wall * ncpu, 1e-9)
        return {"wall_s": wall, "cpu_s": own,
                "nivcsw": ru.ru_nivcsw - self.ru0.ru_nivcsw,
                "others_busy_share": others,
                "loadavg": os.getloadavg()}


def _proc_stat():
    with open("/proc/stat") as fh:
        vals = [int(v) for v in fh.readline().split()[1:]]
    idle = vals[3] + (vals[4] if len(vals) > 4 else 0)
    return sum(vals) - idle, sum(vals)


def card_state(cards: List[Dict[str, str]]) -> list:
    """Clocks, power, power limit and temperature of every card."""
    return [{k: c.get(k) for k in ("index", "clocks.sm", "clocks.mem",
                                   "power.draw", "power.limit",
                                   "temperature.gpu")} for c in cards]
