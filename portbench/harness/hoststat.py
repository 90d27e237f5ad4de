"""The host's state over a window, read from /proc alone and printed on
standard error beside the set-up's parts, so that the spread between runs
of a cell can be laid to its cause: the process's CPU time (all its
threads) over the window, the machine's steal time and load. A reading
that /proc does not give is left out; where /proc is virtualized, steal
and load may read 0."""

import os
import time


def _read(path):
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def _cpu_s():
    """The process's utime + stime in seconds."""
    fields = _read("/proc/self/stat").rpartition(")")[2].split()
    if len(fields) < 13:
        return None
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def _steal():
    """(steal, total) jiffies of the machine, from /proc/stat's cpu line."""
    line = (_read("/proc/stat").splitlines() or [""])[0].split()
    if len(line) < 9 or line[0] != "cpu":
        return None
    return int(line[8]), sum(int(x) for x in line[1:9])


class Window:
    """Readings at start() and stop()."""

    def start(self):
        self.t0, self.cpu0, self.steal0 = time.perf_counter(), _cpu_s(), _steal()

    def stop(self):
        wall = time.perf_counter() - self.t0
        cpu1, steal1 = _cpu_s(), _steal()
        out = {}
        if cpu1 is not None and self.cpu0 is not None and wall > 0:
            out["process_cpu_share"] = (cpu1 - self.cpu0) / wall
        if steal1 and self.steal0 and steal1[1] > self.steal0[1]:
            out["steal_share"] = (steal1[0] - self.steal0[0]) / (steal1[1] - self.steal0[1])
        load = _read("/proc/loadavg").split()
        if load:
            out["loadavg_1m"] = float(load[0])
        return out
