"""Device milliseconds of copies between cards (the "exchange" layer:
parallel/sharded_eds's two transposes and its gather on the lead card),
summed over the cards, per block. Nothing to read on one card."""


def read(ctx):
    s = ctx.layer_s.get("exchange", 0.0)
    if ctx.chips < 2 or not s or not ctx.staged_blocks:
        return None
    return s / ctx.staged_blocks * 1e3
