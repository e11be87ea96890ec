"""align_s (s, host clock): the window's seconds, from the first
alignment's call to the last one's rows on the host with the card
drained, over the alignments it completed."""


def read(run):
    return run.window_s / len(run.alignments)
