"""Assignments kept over the capacity slots the experts ran over in the
window, %, from the MoE layers' device counters (``raw["moe"]``: routed,
kept, slots). The expert products run over every slot, so this is the
useful share of their work; the note gives the share of assignments
dropped, 1 − kept / routed."""


def read(ctx):
    moe = ctx["raw"].get("moe")
    if not moe or moe.get("slots", 0) <= 0:
        return None
    if moe["routed"] > 0:
        ctx["notes"].append(
            f"moe_slot_fill.moe: {moe['kept']} of {moe['slots']} slots "
            f"filled; {moe['routed'] - moe['kept']} of {moe['routed']} "
            f"assignments dropped "
            f"({1.0 - moe['kept'] / moe['routed']:.6f})")
    return 100.0 * moe["kept"] / moe["slots"]
