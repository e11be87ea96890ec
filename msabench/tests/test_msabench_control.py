"""The control: the plain reference aligner (reference/pairwise.py) put
in the program's place and computed in bfloat16, the precision below the
float32 that the configurations state, must come out not correct; the
same reference in float32 must come out correct.  Each sampled pair of
a family is aligned on its own and judged as the run judges the
program's rows (reference/homology.py).

On the CPU at a size a test run can hold (genomes of 2,000 nt); on the
card (``-m card``) at each DNA cell's own size, the seeds in
MSABENCH_CONTROL_SEEDS (comma-separated; three by default), a few pairs
a seed, each reading printed as a JSON line.
"""

import json
import os

import pytest
import torch

from msabench import families, manifest
from msabench.reference import homology, pairwise
from msabench.tests.conftest import ROOT

# pairs aligned per seed on the card (a plastome pair's DP is 156k rows)
CARD_PAIRS = {"plastome_family": 2, "sars2_family": 4}


def reading(cfg, seed, k_pairs, dtype, device):
    """sp_miss of the reference aligner over k_pairs pairs of the seed's
    first family, the pairs drawn as a run draws them."""
    seqs, ids = families.of_config(cfg, seed, 0)
    pairs = homology.sample_pairs(len(seqs), [seed, 0, 1], k_pairs)
    got = pairwise.align_pairs([(seqs[i], seqs[j]) for i, j in pairs],
                               cfg["family"]["alphabet"], dtype, device)
    hit = total = 0
    for (i, j), (ca, cb, width) in zip(pairs, got):
        h, t = homology.pair_counts(ca, ids[i], cb, ids[j], width)
        hit, total = hit + h, total + t
    return 1.0 - hit / total


def test_the_control_is_not_correct_at_a_test_size():
    with open(os.path.join(ROOT, "msabench", "configs",
                           "sars2_family.json")) as fh:
        cfg = json.load(fh)
    cfg = dict(cfg, sequences=4,
               family=dict(cfg["family"], root_len=2000, lo=1900, hi=2100))
    limit = cfg["limits"]["sp_miss"]
    assert reading(cfg, 9, 2, torch.float32, "cpu") <= limit
    assert reading(cfg, 9, 2, torch.bfloat16, "cpu") > limit


@pytest.mark.card
@pytest.mark.parametrize("config", sorted(CARD_PAIRS))
def test_the_control_is_not_correct_at_the_cells_size(card, config):
    cfg = manifest.Manifest(ROOT).config(config)
    limit = cfg["limits"]["sp_miss"]
    seeds = [int(s) for s in os.environ.get(
        "MSABENCH_CONTROL_SEEDS",
        "4000000001,4000000002,4000000003").split(",")]
    for n, seed in enumerate(seeds):
        # the float32 reference once, the bfloat16 control on every seed
        for dtype in (torch.float32, torch.bfloat16)[0 if n == 0 else 1:]:
            miss = reading(cfg, seed, CARD_PAIRS[config], dtype, card)
            print(json.dumps({"config": config, "seed": seed,
                              "dtype": str(dtype), "sp_miss": miss,
                              "limit": limit}), flush=True)
            if dtype == torch.bfloat16:
                assert miss > limit
            else:
                assert miss <= limit
