"""MiB of original data squares (k^2 x 512 bytes a block) committed per
second: every block handed over in the window, over the whole window."""


def read(win):
    return win.blocks * win.k * win.k * 512 / win.window_s / 2**20
