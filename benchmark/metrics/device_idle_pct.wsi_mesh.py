"""The mean over the mesh's cards of each card's idle share of the traced
stretch (one whole slide): the share of the stretch in which no kernel,
copy or memset ran on that card, %."""


def read(facts):
    t = facts["trace"]
    cards = t.get("busy_s_by_card")
    if not cards or t["window_s"] <= 0:
        return None
    return 100.0 * sum(1.0 - b / t["window_s"]
                       for b in cards.values()) / len(cards)
