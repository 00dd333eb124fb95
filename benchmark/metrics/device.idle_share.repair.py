"""``device.idle_share``, read the same way in a withheld-square cell, where it moves
``repair_mib_s``."""

from pathlib import Path

from benchmark.spec import load_reader

read = load_reader(Path(__file__).with_name("device.idle_share.py"))
