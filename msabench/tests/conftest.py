"""The benchmark's own tests (run them with python -m pytest msabench/tests).

Tests that need a CUDA card take the ``card`` fixture and carry the
``card`` marker; the fixture decides, when the test runs, whether a card
is there, and skips without one.  On the card:
python -m pytest msabench/tests -m card -s
"""

import json
import os
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


TINY_CONFIG = {
    "source": "a throwaway configuration of the tests", "reduced": [],
    "precision": "float32 DP scores (Kalign's)",
    "sequences": 6, "warm_sequences": 2,
    "family": {"root_len": 300, "lo": 280, "hi": 320, "clades": 3,
               "alphabet": "dna", "subs": [0.03, 0.015], "max_indel": 3,
               "p_del": 0.5},
    "limits": {"rows_wrong": 0, "sp_miss": 0.05,
               "tree_cherries_split": 0.3, "map_miss": 0.05,
               "bonus_miss": 0.02}}
TINY_TRAFFIC = {"why": "one family a run", "mode": "default",
                "engine": "gpu-fast", "refine": None, "autoroute": True,
                "families": 6, "consistency": {"anchors": 5, "weight": 2.0}}
TINY_READER = '''"""tiny_aligned (count): alignments the window completed."""


def read(run):
    return float(len(run.alignments))
'''


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout holding the repo's BENCHMARK.json and msabench/ files,
    with a cell, a configuration, a traffic mix and a per-layer metric
    added by new files and new entries only."""
    for sub in ("configs", "traffic", "metrics", "checks"):
        shutil.copytree(os.path.join(ROOT, "msabench", sub),
                        tmp_path / "msabench" / sub)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    (tmp_path / "msabench" / "configs" / "tiny_dna.json").write_text(
        json.dumps(TINY_CONFIG))
    (tmp_path / "msabench" / "traffic" / "tiny.json").write_text(
        json.dumps(TINY_TRAFFIC))
    (tmp_path / "msabench" / "metrics" / "tiny_aligned.py").write_text(
        TINY_READER)
    bench["configs"].append({"name": "tiny_dna", "source": "tests",
                             "file": "msabench/configs/tiny_dna.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "tiny", "config": "tiny_dna",
                               "traffic": "tiny", "chips": 1,
                               "why": "tests"})
    bench["per_layer"].append({"name": "tiny_aligned", "unit": "count",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "progressive pass",
                               "moves": "align_s", "workloads": ["tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(tmp_path)
