"""MiB of original data squares (k^2 x 512 bytes a block) repaired per
second of the repair's own calls: every block of the window over the sum
of its calls' seconds, from the withheld square handed over on the host
to the repaired square back on the host. The hand-overs' preparation
between the calls, which the window also holds, is left out."""


def read(win):
    if not win.latencies_s:
        return None
    return win.blocks * win.k * win.k * 512 / sum(win.latencies_s) / 2**20
