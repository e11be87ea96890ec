"""Long families through the engine's wide routes on the CPU, against
kalign_tpu's tpu-fast (KALIGN_TPU_NO_RESIDENT, KALIGN_TPU_NO_AUTOROUTE):
the wave route (kalign_tpu_torch/gpu/gotoh_wave.py) forced at the long
family's widths, and launches past 7,168 columns sized down to one real
problem by GpuEngine.WIDE_LAUNCH_BYTES.  Tolerance: FASTA byte-identical;
the wide launches hold only real problems (no 8 x 8 pads)."""

import numpy as np
import pytest

from kalign_tpu import engine as JE
from kalign_tpu.core import io as jio
from kalign_tpu.core.msa import Msa as JMsa
from kalign_tpu_torch import engine as TE
from kalign_tpu_torch.core import io as tio
from kalign_tpu_torch.core.msa import Msa as TMsa
from kalign_tpu_torch.gpu import gotoh_row, gotoh_wave
from kalign_tpu_torch.gpu.engine import GpuEngine


def _long_family_fasta(seqs, consistency, monkeypatch):
    monkeypatch.setenv("KALIGN_TPU_NO_RESIDENT", "1")
    monkeypatch.setenv("KALIGN_TPU_NO_AUTOROUTE", "1")
    m = JMsa.from_sequences(seqs)
    m.quiet = True
    ref = JE.align_msa(m, consistency_anchors=consistency, engine="tpu-fast")
    m = TMsa.from_sequences(seqs)
    m.quiet = True
    out = TE.align_msa(m, consistency_anchors=consistency, device="cpu",
                       autoroute=False)
    return out, tio.format_alignment(out, "fasta"), \
        jio.format_alignment(ref, "fasta")


@pytest.mark.parametrize("consistency", [0, 5])
def test_long_family_through_the_forced_wave_route(consistency,
                                                   monkeypatch):
    """chip_smoke's long family (fragments and one ~7,300-residue
    protein), its merges and map DPs past 7,168 columns forced onto the
    wave route (4 bands of 2,048 columns, blocks of 100 rows): FASTA
    byte-identical to kalign_tpu's tpu-fast, scores bitwise; the wide
    launches hold only real problems."""
    import chip_smoke
    seqs = chip_smoke.long_family(0)
    calls = []
    forward = gotoh_wave.forward_operands

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return forward(*a, **kw)
    monkeypatch.setattr(gotoh_row, "CLUSTER_MAX_WIDTH", 7168)
    monkeypatch.setattr(gotoh_row, "WAVE_CLUSTER", 1)
    monkeypatch.setattr(gotoh_row, "WAVE_BANDS", 4)
    monkeypatch.setattr(gotoh_wave, "MIN_ROWS", 100)
    monkeypatch.setattr(gotoh_wave, "BLOCK_BYTES", 0)
    monkeypatch.setattr(gotoh_wave, "forward_operands", spy)
    out, got, want = _long_family_fasta(seqs, consistency, monkeypatch)
    assert calls and got == want
    wide = [b for b in out.engine_stats["batches"]
            if b["route"] == "row" and b["L2p"] > 7168]
    assert wide and all(np.all(b["lb"] > 8) for b in wide)
    assert sum(len(b["la"]) for b in wide) == sum(s[0] for s in calls)


def test_long_family_in_one_problem_launches(monkeypatch):
    """The long family in default mode with WIDE_LAUNCH_BYTES below one
    problem: every launch past 7,168 columns holds one real problem (the
    cluster widths, the plain row DP here), FASTA = tpu-fast's."""
    import chip_smoke
    seqs = chip_smoke.long_family(0)
    monkeypatch.setattr(GpuEngine, "WIDE_LAUNCH_BYTES", 1)
    out, got, want = _long_family_fasta(seqs, 5, monkeypatch)
    wide = [b for b in out.engine_stats["batches"]
            if b["route"] == "row" and b["L2p"] > 7168]
    assert wide and all(len(b["la"]) == 1 for b in wide)
    assert got == want
