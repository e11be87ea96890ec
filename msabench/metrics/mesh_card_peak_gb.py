"""mesh_card_peak_gb (GB, device trace): the largest
torch.cuda.max_memory_allocated(d) over the cards of the run, where
peak_mem_gb reads the first card only.  The run resets the first card's
peak before the window; the other cards' count from set-up on, whose
warm alignment is one of the family's own length.  None off the card."""


def read(run):
    if run.device == "cpu":
        return None
    import torch
    peaks = [torch.cuda.max_memory_allocated(d)
             for d in range(torch.cuda.device_count())]
    return max(peaks) / 1e9 if peaks else None
