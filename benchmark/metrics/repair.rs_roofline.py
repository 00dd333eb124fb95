"""``rs_roofline`` in a withheld-square cell, where it moves
``repair_mib_s``: a one-quadrant repair decodes k axes, then 2k, each a k
to k coding of one line, so its least work is the extension's three
passes of k lines (work.extension_least_s)."""

from pathlib import Path

from benchmark.spec import load_reader

read = load_reader(Path(__file__).with_name("rs_roofline.py"))
