"""progressive_fetches (count, program counter): the progressive pass's
device-to-host transfers per alignment (engine_stats["fetches"]: one
per guide-tree level plus one)."""


def read(run):
    vals = [a["fetches"] for a in run.alignments if a["fetches"] is not None]
    return sum(vals) / len(vals) if vals else None
