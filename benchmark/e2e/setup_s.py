"""Seconds from process start to the window: imports, the kernels' load
(their build in a run that compiles), the input pool, the warm calls."""


def read(win):
    return win.setup_s
