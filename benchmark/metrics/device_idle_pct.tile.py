"""The share of the traced stretch of the tile window in which no kernel,
copy or memset ran on the card, %."""


def read(facts):
    t = facts["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t["window_s"] > 0 else None
