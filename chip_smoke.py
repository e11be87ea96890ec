#!/usr/bin/env python3
"""Smoke run of kalign_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device and build: the card's name and power limit, then the CUDA
     kernels and the native tree library built from this checkout;
  2. edge cases: every hand-written kernel held against its plain
     PyTorch version on the same inputs (bitwise / exact; the plain
     versions that are loops of small operations -- lanewise, fused, the
     walk, BPM and its table, the sweep -- on CPU copies in HOST_WORKERS
     worker processes while the card goes on, each checked before the
     kernels line), with
     la = 0 and lb = 0 problems, short and odd-sized inputs (for the
     walk: walks across many windows, pure-gap walks, a short max_steps
     and walks longer than its step buffer; for the fused kernel: nc = 1,
     5, 8, 23 and 32, rows past a strip, one decision word per row; for
     the cluster row kernel: 1 x 128 x 7,296, 8 x 512 x 8,192 with full
     and short lengths and lb at band edges (also under clusters of 2, 4,
     8 and 16 blocks), 2 x 256 x 16,384, 1 x 64 x 114,688, and a narrow
     row in 3 and 4 bands (the last past the row), each launched twice;
     for the wave route (past 114,688 columns): 1 x 64 x 131,072 and
     1 x 64 x 114,816 under its plan, lb at a band's edge and la < L1p,
     several blocks of rows a problem, and a narrow row under forced
     plans of 1-3 blocks a cluster (edge_cases_wave); for the match
     preparation: PREPARE_EDGE, K = 0, 1, 5, 9 and 16, W tails that are
     not a tile's multiple, rows whose anchors are all -1, row0 / col0
     offsets, B = 1 and 8 (edge_cases_prepare); for BPM and its
     mask-table kernel: every instantiation, nblk 1..16, with m = 0, 1,
     64, 65 and 64*nblk, texts past 1,024, P = 1, and the guide tree's
     leaf-set pairs of the SARS-CoV-2-length genomes against the native
     tree's own loop (edge_cases_tree_pairs); for the k-means Lloyd
     kernel, in both of its forms: clusters of exactly 50, 51 and 2,048
     rows, D = 5 anchors, rows that tie within EPS and rows all alike,
     each launched twice for the same bits);
  2b. the exact engine: its canary on the card (a line of its own), then
     the wavefront sweep kernel bitwise against its plain version on
     single windows at the edges (one row, one column, start = end,
     init_tg / start_tg / end_tg) in match and chain form, on launches
     captured from BB30014 in default mode on the card (the pre-pass's
     residue pairs in grids packed to exact.PACK_BUDGET rows; merges of
     residues x residues, profile x residues, profile x profile), on tall
     windows (TALL_WINDOWS: 8,192 and 16,384 rows, swept in strips; each
     whole recursion also against the native oracle) and on the tallest
     launch of a long divergent family
     (LONG_DIVERGENT_*: routed to the exact engine in --fast mode, FASTA
     equal to the host engine's);
  3. ten paths, each aligned on the card with the device-resident
     progressive pass (launch counts set to 0 just before and read just
     after; every kernel of the path must have launched, and none it
     must not; but for "divergent" and "precise", the engine gpu-fast,
     the mean anchor distance below the autoroute's 0.5; one fetch per
     guide-tree level plus one), then, but for "precise", with the
     host-assembled pass
     (GpuEngine(resident=False)), whose FASTA must be the same; each
     path line gives both walls, the phase split and the progressive
     pass's host split (assembly, bonus, dispatch, merge, weave, fetch):
     "fast", a 2,000-sequence protein family (270-330 residues, made
     from a seed) with align_msa(mode="fast"); "default", a 2,000-sequence
     16S-V4-like DNA family (240-270 nt) with mode="default", anchor
     consistency with 5 anchors (~10,000 map DPs on the fused kernel,
     then the pass with the consistency bonus); "protein_default", the
     protein family in default mode (map DPs on the match stream);
     "large_default", 16,384 protein sequences in default mode, whose
     guide tree is the fused device k-means tree (the Lloyd kernel) and
     whose host-assembled pass is not run (it would take minutes);
     "refine_confident", the 2,000-sequence protein family in default
     mode with refine="confident" (a probe pass, then the flagged merges
     again with three candidates), whose host-assembled pass must give
     the same FASTA or part ways at a near-SP-tie (refine_divergence);
     "long_default", LONG_GENOMES_N DNA sequences of HIV-1's length
     (long_genomes: 9,200-9,900 nt) in default mode, resident pass only,
     every map DP and merge on the cluster row kernel (no wave launch),
     the mean anchor distance below the autoroute's 0.5;
     "sars2_default", SARS2_N genomes of SARS-CoV-2's length (29,400-
     30,300 nt), default mode, resident pass only, every DP on the cluster
     row kernel, the bonus through prepare_match, no wave launch;
     "plastome_default", PLASTOME_N genomes of a plastome's length
     (150,000-160,000 nt), default mode, resident pass only, every map DP
     and merge on the wave route (no cluster or register row launch);
     "divergent", DIVERGENT_N protein sequences whose mean anchor
     distance lies in DIVERGENT_DISTANCE, default mode with the default
     gpu-fast engine: it must route to the exact engine "gpu", launch
     bpm and exact_sweep, and give the host engine's FASTA byte for byte
     (the host engine's wall beside it, and gpu-fast's with the route
     off);
     "precise", PRECISE_N protein sequences of the family's kind with
     align_msa(mode="precise"): three ensemble runs, each realigned once,
     POAR selection or consensus and, after a selection, a
     REFINE_CONFIDENT run (phase_precise: the kernels of
     PRECISE["launch"] launched, none of PRECISE["forbid"], every run on
     gpu-fast, confidences in [0, 1]; the wall, its split, the winner;
     its largest row launch held bitwise against the plain version);
  3b. the serve path (phase_serve): a warm server (serve.serve, its
     warmup on) in a thread of this process answers a request stream
     (serve_requests: BAliBASE families in default and --fast mode,
     BB30014 routed to the exact engine, small.fa --precise -f sto, the
     2,000-protein and 2,000-DNA families, engine "auto" on tiny.fa and
     on the protein family, a missing input, BB11001 three more times,
     two --trace requests) sent with relative paths from a scratch
     directory; launch counts set to 0 once the warmup is done and read
     after the last request (the warmup's apart); every output equal to
     the same argv run one-shot through cli.main here, BB30014 and
     tiny.fa to their golden files; the --trace request's trace naming
     its kernels, its device seconds in (0, wall]; then the cold start
     in fresh processes: a one-shot CLI call, a --server-start call
     (the spawned server's ready time and first request), a --server
     call to the warm server, and the import of the aligner;
  3c. the mesh (the engine gpu-mesh; shards: every visible card where
     there are several, else MESH_SHARDS on cuda:0, each on its own
     stream): mesh_edge, the band kernel (csrc/gotoh_mesh.cu) bitwise
     against its plain version and the unsplit row DP at 2, 3 and 4
     shards (MESH_EDGE: clusters of one block and of several, of 4 and
     of 8 columns a thread, and the wave route past 114,688 columns at
     2 x 64 and 2 x 512 x 229,632, timed there beside each band cut into
     MESH_SUB_BANDS sub-bands on the cluster route, and a leading gap
     run of exactly one band);
     "mesh_default", the protein family in default mode on gpu-mesh
     (bpm, bpm_table, prefix_sum, traceback and gotoh_row launched, no
     lanewise or fused launch), and "mesh_long", the long genomes in
     default mode on gpu-mesh (the cluster row kernel and the band
     kernel launched), "mesh_sars2" and "mesh_plastome", the SARS-CoV-2-
     and plastome-length genomes in default mode on gpu-mesh (F6: launches
     past 7,168 columns hold real problems only, each band's match made a
     block of rows at a time; the peak device memory printed; no one-shard
     run), "mesh_wide", wide_family() (a 236,000-nt genome and eight
     copies of a 20,000-nt region of it) on two shards: its merges of a
     region's profile against the genome take bands past 114,688
     columns, the band kernel's wave route; each with launch counts set
     to 0 just before and read just after, FASTA equal to one shard's
     and to gpu-fast's (the protein_default / long_default /
     sars2_default / plastome_default paths', mesh_wide's aligned
     here); mesh_wide's widest merge as LongQueue runs it on its two
     shards, bitwise against the same merge on one card's wave route
     (wide_merge: rows, columns, launches, walls, peak memory); the
     mesh_long path's root
     merge rebuilt as the engine builds it, the band kernel held against
     its plain version and the cluster row kernel on the same match,
     fed its band sources against fed whole bands, timed beside them
     with its bound and the host's enqueue (the sweeps that chose the
     plan run only under --only mesh_sweep); mesh_procs, MESH_PROCS
     processes under init_distributed with two shards each: their
     sharded distances and bucket equal to one process's, and small.fa's
     3-run ensemble split by my_ensemble_runs and merged equal to the
     CLI's sequential --ensemble 3;
  4. the paths but the refined one, protein_default, large_default,
     divergent and the SARS-CoV-2 and plastome ones (those under --only
     profile:NAME)
     once more under torch.profiler:
     device time by kernel and by part of the progressive pass, each
     kernel's total device time and launches (the trace must hold every
     launch of phase 3), and the device's idle share;
  4b. the device tree at the large path's own anchor distances: each
     entry point through the kernel twice (the same tasks) and through
     its plain version on the card (the same tasks, or a first split made
     otherwise whose best tries' SSE agree to rel 1e-5), beside the
     native tree's seconds; a lowered depth cap; the kernel's root split
     timed beside its plain version and its bound;
  5. the same package on the card and on the CPU: BB30014 (routed to
     the exact engine) and a 150-sequence protein family in --fast mode,
     BB30014 (routed; also the golden file) and a 250-sequence DNA family
     (one 2,048-problem fused launch) in default mode, BB12006 through
     engine "gpu" in default mode (also the golden file): identical
     FASTA, or equal per-merge scores where a near-tie resolved
     differently; a long family (three fragments of 200-400
     residues and one of ~7,300, merges wider than 7,168 columns) in both
     modes: identical FASTA, the cluster row kernel launched; the same
     family in default mode with every DP past 7,168 columns on the wave
     route: identical FASTA, the wave kernel launched; BB11001
     with refine="all" in --fast mode, small.fa with mode "precise" and
     as a 3-run ensemble without realign (tree noise on runs 1 and 2),
     and post-realign of the golden BB11001 alignment (refine confident,
     2 iterations): identical FASTA; BB12006 in default mode on gpu-mesh
     over 4 shards of one device (cuda:0, the CPU) with every merge on
     the column-sharded route: identical FASTA;
  5b. the bit-exact engine "gpu" on the card against golden files
     (CARD_GOLDENS): small.fa as a 3-run ensemble with realign 1
     (small.precise.afa) and big_prot.fa with realign 1
     (big_prot.realign.afa), byte for byte;
  6. main-path shapes: every kernel held bitwise against its plain
     version again, at the shapes and problem lengths the paths gave it
     (its largest launch; for the row kernel also its widest and the
     default path's largest launch of few problems, each under every
     block size that fits; for the cluster row kernel the long_default
     path's largest map-DP and progressive launches, the long family's
     largest launch and 8 x 512 x 8,192 and 2 x 256 x 16,384, with the
     device memory one wide launch takes (and one problem on the wave
     route, beside the memory guard's model; a launch with a bonus must
     take at most 0.5 bytes a cell more than one without); for the wave
     route the plastome path's root merge as the engine runs it, every
     launch timed, its first two blocks of rows and its last held against
     the plain version from the same state, the first two blocks' rows
     also through PR 14's band pipeline on shards of this card (held and
     timed beside it), and 1 x 64 x 131,072; for the match preparation
     the root merge's first block, long_default's largest progressive
     launch and a serve-path launch; for the prefix sums also the
     widest row launch's [B, L2p]; for the walk each decision layout
     apart and the widest row launch's walks; for the fused kernel every
     launch shape of the default path), and timed there beside its plain
     version and its bound (the walk also beside its chain floor: its
     steps and the windows it staged at this card's shared-memory and
     device-memory latencies, measured by scripts/latency_probe.cu); the
     fused kernel also beside the materialised route (torch.bmm +
     lanewise kernel) on the same inputs; BPM and its table at both
     paths' distance stages and at one full 262,144-pair chunk (8,192
     sequences x 32 anchors), the table also at the large path's 16,384
     rows and long_default's nblk 16 (bpm_table_shape); the sweep at the
     divergent path's largest launch;
  7. one JSON line with every kernel's numbers, the nvidia-smi line, and
     the last line {"ok": true, "device": {...}}.
Without a card, or outside a checkout of the repository, it prints no
result and exits non-zero. ``--only PHASES`` runs the build and the named
phases alone (run_only) and prints no result lines.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s device memory; 67 TFLOP/s
# fp32 counts a fused multiply-add as two operations, so plain fp32
# add/max/compare ops run at 33.5e12/s; integer ALU lanes are half the
# fp32 lanes (64 per SM): 16.7e12 int32 ops/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12
INT32_OPS_PER_S = 16.7e12
# fp32 operations per DP cell of the Gotoh kernels (bias 3, diagonal
# candidates 4, A 1, GB 4, GA 3, decision compares 4); the fused kernel
# adds nc multiplies and nc - 1 adds for the match
GOTOH_OPS_PER_CELL = 19
# 32-bit integer operations per (pair, text symbol, live block) step of
# the BPM kernel: one 64-bit Myers block step on lo/hi words with Hopper's
# 3-input logic (LOP3) and add with carry: t = (eq | h-) & pv 2, s = t +
# pv 2, xh 3, ph 2, mh 2, the carry out 2, ph and mh shifted with the
# carry in 5, vp 4, vn 2, the score 1
BPM_OPS_PER_BLOCK_STEP = 25
# the pointer chases that measure the walk's chain floor
PROBE_SRC = os.path.join(HERE, "scripts", "latency_probe.cu")
# seconds of idle time at each end of a torch.profiler capture: on the
# card's machine the trace's kernel timestamps stray from the host's
# clock, and the profiler drops records that fall outside its window;
# runs of this script lost a path's first kernels (launched ~1 s into
# the capture) in three captures in a row at 0.05 s and at 0.5 s, and a
# path's last ones at 0.05 s
PROFILE_PAD_S = 2.0

PROTEIN = "ARNDCQEGHILKMFPSTWYV"
DNA = "ACGT"

KERNELS = {
    "gotoh_row": ("kalign_tpu_torch/csrc/gotoh_row.cu",
                  "kalign_tpu/tpu/gotoh_pallas.py:272 (_kernel :112)"),
    "gotoh_lanewise": ("kalign_tpu_torch/csrc/gotoh_lanewise.cu",
                       "kalign_tpu/tpu/gotoh_lanewise.py:357 (_kernel :132)"),
    "bpm": ("kalign_tpu_torch/csrc/bpm.cu",
            "kalign_tpu/tpu/bpm_pallas.py:213 (_kernel :80)"),
    "bpm_table": ("kalign_tpu_torch/csrc/bpm.cu",
                  "kalign_tpu/parallel/mesh.py:106 (tpu/bpm.py:51 build_peq "
                  "per pair, feeding bpm_batch_pallas; XLA, not Pallas)"),
    "traceback": ("kalign_tpu_torch/csrc/traceback.cu",
                  "kalign_tpu/tpu/traceback.py:32 (_walk; XLA, not Pallas)"),
    "prefix_sum": ("kalign_tpu_torch/csrc/scan.cu",
                   "kalign_tpu/tpu/gotoh_pallas.py:309 (cumsum feeding "
                   "_kernel; XLA, not Pallas)"),
    "gotoh_fused": ("kalign_tpu_torch/csrc/gotoh_lanewise.cu",
                    "kalign_tpu/tpu/gotoh_lanewise.py:692 "
                    "(_fused_kernel :525)"),
    "gotoh_row_wave": ("kalign_tpu_torch/csrc/gotoh_row_wave.cu",
                       "kalign_tpu/tpu/gotoh_pallas.py:272 (_kernel :112) "
                       "past its plan's widths, where kalign_tpu runs "
                       "tpu/gotoh.py:47 gotoh_forward (XLA, not Pallas); "
                       "here past 114,688 columns, the design of "
                       "kalign_tpu/parallel/mesh.py:288 sharded_long_gotoh"),
    "prepare_match": ("kalign_tpu_torch/csrc/prepare_match.cu",
                      "kalign_tpu/tpu/engine.py:71 _prepare_match (centering "
                      "bias and K-anchor bonus; XLA, not Pallas)"),
    "gotoh_row_cluster": ("kalign_tpu_torch/csrc/gotoh_row.cu",
                          "kalign_tpu/tpu/gotoh_pallas.py:272 (_kernel :112)"
                          " past its plan's widths, where kalign_tpu runs "
                          "tpu/gotoh.py:47 gotoh_forward (XLA, not Pallas); "
                          "the design of kalign_tpu/parallel/mesh.py:288 "
                          "sharded_long_gotoh"),
    "kmeans": ("kalign_tpu_torch/csrc/kmeans.cu",
               "kalign_tpu/tpu/kmeans.py:46 _lloyd_batch / :322 "
               "_fused_splits (XLA, not Pallas)"),
    "exact_sweep": ("kalign_tpu_torch/csrc/exact_sweep.cu",
                    "kalign_tpu/tpu/exact.py:65 _sweep_one / :163 "
                    "_sweep_batch (XLA, not Pallas)"),
    "gotoh_mesh": ("kalign_tpu_torch/csrc/gotoh_mesh.cu",
                   "kalign_tpu/parallel/mesh.py:288 sharded_long_gotoh "
                   "(shard_map + lax.ppermute; XLA, not Pallas); the "
                   "wave route, bands past 114,688 columns (a wavefront "
                   "of thread-block clusters)"),
    "gotoh_mesh_cluster": ("kalign_tpu_torch/csrc/gotoh_mesh.cu",
                           "kalign_tpu/parallel/mesh.py:288 "
                           "sharded_long_gotoh (shard_map + lax.ppermute; "
                           "XLA, not Pallas); bands up to 114,688 columns "
                           "(a thread-block cluster)"),
}
# a substring of each kernel's name in a torch.profiler trace
PROFILE_NAMES = {"gotoh_row": "gotoh_row_kernel",
                 "gotoh_lanewise": "MatchStream", "bpm": "bpm_kernel",
                 "bpm_table": "peq_table_kernel",
                 "traceback": "walk_kernel", "prefix_sum": "prefix_sum_kernel",
                 "gotoh_fused": "FusedOperands",
                 "gotoh_row_wave": "gotoh_row_wave_kernel",
                 "prepare_match": "prepare_match_kernel",
                 "gotoh_row_cluster": "gotoh_row_cluster_kernel",
                 "kmeans": "lloyd_kernel",
                 "exact_sweep": "exact_sweep_kernel",
                 "gotoh_mesh": "gotoh_band_wave_kernel",
                 "gotoh_mesh_cluster": "gotoh_band_cluster_kernel"}
# the paths: mode, the kernels the path must launch (and those it must
# not), refinement, whether the host-assembled pass runs too (it would
# take minutes at 16,384 sequences, and densify a 378 MB bonus per
# problem some 80 times on the long genomes) and whether a profiled run
# follows; the long family's cases of phase_gpu_vs_cpu must launch the
# cluster row kernel.  Default mode adds the consistency bonus through
# prepare_match.  The genome paths (long_default, sars2_default,
# plastome_default) run the resident pass only.  Profiled runs of
# protein_default, large_default, default and long_default (30, 67, 43
# and 30 s of whole runs of 1,050-1,100 s on an H100 80GB HBM3 at 700 W)
# run only under --only profile:NAME, so that the run stays within its
# time limit
NARROW = [k for k in KERNELS
          if k not in ("gotoh_fused", "gotoh_row_wave", "gotoh_row_cluster",
                       "kmeans", "exact_sweep", "gotoh_mesh",
                       "gotoh_mesh_cluster", "prepare_match")]
WIDE = ["bpm", "bpm_table", "prefix_sum", "traceback", "gotoh_row_cluster"]
BONUS = ["prepare_match"]
GENOME_BASE = ["bpm", "bpm_table", "prefix_sum", "traceback"]
PATHS = {"fast": dict(mode="fast", launch=NARROW),
         "default": dict(mode="default",
                         launch=NARROW + ["gotoh_fused"] + BONUS,
                         profile=False),
         "protein_default": dict(mode="default", launch=NARROW + BONUS,
                                 profile=False),
         "large_default": dict(mode="default",
                               launch=NARROW + ["kmeans"] + BONUS,
                               host_pass=False, profile=False),
         "refine_confident": dict(mode="default", launch=NARROW + BONUS,
                                  refine="confident", profile=False),
         "long_default": dict(mode="default", launch=WIDE + BONUS,
                              forbid=["gotoh_row_wave"], host_pass=False,
                              profile=False),
         # SARS-CoV-2-length genomes: every DP on the cluster row kernel
         "sars2_default": dict(mode="default", launch=WIDE + BONUS,
                               forbid=["gotoh_row_wave"], host_pass=False,
                               profile=False),
         # plastome-length genomes: every map DP and merge on the wave
         "plastome_default": dict(mode="default",
                                  launch=GENOME_BASE + ["gotoh_row_wave"]
                                  + BONUS,
                                  forbid=["gotoh_row_cluster", "gotoh_row",
                                          "gotoh_lanewise", "gotoh_fused"],
                                  host_pass=False, profile=False),
         # 8 genomes of ~236 kb on one card (--only path:hcmv_default;
         # ~60 GB a DP): mesh_hcmv's FASTA is held to it
         "hcmv_default": dict(mode="default",
                              launch=GENOME_BASE + ["gotoh_row_wave"]
                              + BONUS,
                              forbid=["gotoh_row_cluster", "gotoh_row",
                                      "gotoh_lanewise", "gotoh_fused"],
                              host_pass=False, profile=False)}
# the precise path: mode "precise" (an ensemble of 3 runs, each with one
# realign pass, consistency K = 5) on PRECISE_N proteins of the protein
# family's kind; its POAR tables are host work over N (N - 1) / 2 pairs
# per run, so N stays at a family's size, not thousands; its map DPs
# (PRECISE_N x 5) fill 1,024-problem launches of the match stream
PRECISE_N = 400
PRECISE_SEED = 11
PRECISE = dict(mode="precise",
               launch=["bpm", "bpm_table", "prefix_sum", "traceback",
                       "gotoh_row", "gotoh_lanewise", "prepare_match"],
               forbid=["gotoh_row_wave", "gotoh_row_cluster",
                       "exact_sweep"])
# golden files the bit-exact engine "gpu" must give on the card: (input,
# ensemble runs, realign passes), default mode
CARD_GOLDENS = {"small.precise.afa": ("small.fa", 3, 1),
                "big_prot.realign.afa": ("big_prot.fa", 0, 1)}
# the long_default path: LONG_GENOMES_N DNA sequences of HIV-1's length
# (the HXB2 reference, GenBank K03455, is 9,719 nt); the mean anchor
# distance of every path's input must stay below the autoroute's 0.5 (on
# gpu-fast)
LONG_GENOMES_N = 128
LONG_GENOMES_SUBS = (0.06, 0.03)
AUTOROUTE_DISTANCE = 0.5
# the sars2_default path: SARS2_N genomes of SARS-CoV-2's length (the
# Wuhan-Hu-1 reference, GenBank MN908947.3, is 29,903 nt); the
# plastome_default path: PLASTOME_N genomes of a plastome's length (the
# tobacco chloroplast genome, GenBank Z00044 / NC_001879, 155,943 bp);
# the cuts: 64 and 8 genomes, not the thousands of SARS-CoV-2 genomes
# users align
SARS2_N, SARS2_LEN, SARS2_SUBS = 64, 29903, (0.02, 0.01)
PLASTOME_N, PLASTOME_LEN, PLASTOME_SUBS = 8, 155943, (0.03, 0.015)
# the mesh_wide path: one genome of a human cytomegalovirus's length (the
# Merlin strain, GenBank AY446894, 235,646 bp) and WIDE_N sequences of
# one WIDE_REGION-nt region of it (a locus sequenced across strains):
# merges of a region's profile against the genome are ~236,000 columns
# wide, past two 114,688-column bands; the cut: one genome (two such
# genomes' merge, ~236,000 squared, would not fit one card)
WIDE_N, WIDE_LEN, WIDE_REGION, WIDE_SUBS = 8, 236000, 20000, (0.01, 0.02)
# hcmv_genomes: 8 genomes of ~236 kb (the hcmv_default and mesh_hcmv
# paths, mesh_pairs)
HCMV_N, HCMV_LEN, HCMV_SUBS = 8, 236000, (0.01, 0.005)
# fp32 operations per cluster member, iteration and try of the k-means
# Lloyd kernel, at D anchors: two D-long dot products (2D multiplies,
# 2D - 2 adds), the two squared distances (1 multiply, 2 adds each), the
# clamps and square roots (4), the tie test and side (4), the SSE's
# minimum and add and the side's count (3), and the D adds of the side's
# sums (csrc/kmeans.cu); ||x||^2 is a per-row constant and not counted
KMEANS_OPS = lambda D: 5 * D + 15
# the k-means check's tolerance: a split made otherwise must tie, its
# best tries' SSE equal to rel 1e-5 (gpu/kmeans.py)
KMEANS_SSE_RTOL = 1e-5
# fp32 operations per processed cell of the exact engine's sweep: the
# diagonal candidates (2 adds, 2 max), the match and bonus adds (2), GA
# (2 adds, 1 max), GB (2 adds, 1 max; the terminal form 1 max, 1 add)
# and the selects (3); the profile x profile chain adds 23 multiplies and
# 23 adds (csrc/exact_sweep.cu)
SWEEP_OPS_PER_CELL = 15
SWEEP_CHAIN_OPS = 46
# the divergent path: sequences, and the protein family's divergence
# (mean anchor distance in DIVERGENT_DISTANCE, the autoroute's range)
DIVERGENT_N = 2000
DIVERGENT_SUBS = (0.25, 0.15)
DIVERGENT_DISTANCE = (0.52, 0.60)
# the sweep's tall windows (swept in strips: past 1,024 virtual rows, 512
# in chain form): (rows la, operand mode) of one window of TALL_LB
# columns, VR 8,192 and 16,384
TALL_WINDOWS = ((10000, 0), (20000, 2))
TALL_LB = 300
# the long divergent family: LONG_DIVERGENT_SHORT sequences of the
# divergent family and two of ~LONG_DIVERGENT_LEN residues (mean anchor
# distance ~0.52, so gpu-fast routes it to the exact engine, whose merges
# of the long pair take 8,192-row grids)
LONG_DIVERGENT_SHORT = 30
LONG_DIVERGENT_LEN = 10000


T_START = time.perf_counter()
# a file that also gets every JSON line (``--log``)
LOG = None


def emit(obj):
    """One JSON line, with the seconds since the script started; the
    phase and those seconds also on standard error (where a run that was
    stopped shows how far it got)."""
    obj = dict(obj, t_s=round(time.perf_counter() - T_START, 1))
    line = json.dumps(obj)
    print(line, flush=True)
    what = obj.get("path") or obj.get("kernel") or ""
    print(f"chip_smoke: {obj.get('phase')} {what} at {obj['t_s']} s",
          file=sys.stderr, flush=True)
    if LOG is not None:
        with open(LOG, "a") as fh:
            fh.write(line + "\n")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_time_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def dev_us(e):
    """Device time of a torch.profiler key_averages() entry, in us."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def profiled(fn, cpu=True):
    """torch.profiler's trace of fn() (CUDA activity, and the CPU's with
    cpu), the card drained and the capture window padded by PROFILE_PAD_S
    on each side; returns (trace, fn's result, fn's wall seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]
                 + [ProfilerActivity.CPU] * cpu) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILE_PAD_S)
    return prof, out, wall


def device_ms(fn, reps: int) -> float:
    """Device time per call of fn(): CUDA events around reps calls queued
    behind a spin kernel, so that the card runs them back to back while
    the host is still launching them (the host's launch time is hidden,
    the card's gap between kernels is not).  The spin doubles until it
    outlasts the host's launches.  Not torch.profiler: on the card's
    machine its traces of short windows lost kernel records (PERF.md)."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    for _ in range(10):
        spin, t0, t1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
        h0 = time.perf_counter()
        spin.record()
        torch.cuda._sleep(cycles)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        host_ms = (time.perf_counter() - h0) * 1e3
        torch.cuda.synchronize()
        if spin.elapsed_time(t0) > host_ms:
            return t0.elapsed_time(t1) / reps
        cycles *= 2
    raise AssertionError("the spin kernel never outlasted the host's "
                         "launches")


def timed_once(fn):
    """(fn(), wall ms) of one call, the card drained before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


# ---------------------------------------------------------------------------
# host work beside the card: the plain versions that run on the CPU (loops of
# small operations, which the host runs faster than it launches them on the
# card; the same float32 operations, so the same bits) and the CPU side of
# gpu_vs_cpu run in HOST_WORKERS spawned processes of one torch thread each,
# at a lower priority than this one, while the card's phases go on.  A plain
# version's check is made when its result is back (settle(), before the
# kernels line), on CPU copies of the kernel's outputs.  Four workers slowed
# the precise path's host loops 2.2x (an H100 host of 8 cores: PERF.md).
HOST_WORKERS = 3
HOST_NICE = 10
HOST = {"pool": None, "pending": []}


class HostTensor:
    """A tensor on its way to or from a host worker, as a numpy array."""

    def __init__(self, a):
        self.a = a


def to_host(x):
    """x with every tensor (in tuples, lists and dicts too) a HostTensor."""
    import torch
    if isinstance(x, torch.Tensor):
        return HostTensor(x.detach().cpu().numpy())
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_host(v) for v in x)
    return x


def from_host(x):
    """to_host's inverse: CPU tensors."""
    import torch
    if isinstance(x, HostTensor):
        return torch.from_numpy(x.a)
    if isinstance(x, dict):
        return {k: from_host(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(from_host(v) for v in x)
    return x


def host_init():
    import torch
    os.nice(HOST_NICE)
    torch.set_num_threads(1)


def host_pool():
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    if HOST["pool"] is None:
        HOST["pool"] = ProcessPoolExecutor(
            HOST_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=host_init)
    return HOST["pool"]


def host_call(fn, args):
    """In a host worker: (fn(*args) on CPU tensors, to_host; wall ms)."""
    args = from_host(args)
    t0 = time.perf_counter()
    out = fn(*args)
    return to_host(out), (time.perf_counter() - t0) * 1e3


def later(fn, args, check):
    """fn(*args) in a host worker on CPU copies of args; check(its output,
    its wall ms) is called by settle()."""
    HOST["pending"].append(
        (host_pool().submit(host_call, fn, to_host(args)), check))


def settle():
    """Every check handed out by later(), in the order it was handed out."""
    while HOST["pending"]:
        fut, check = HOST["pending"].pop(0)
        out, ms = fut.result()
        check(from_host(out), ms)


def stop_host():
    """End the host workers, whatever they are running."""
    pool, HOST["pool"] = HOST["pool"], None
    HOST["pending"].clear()
    if pool is not None:
        procs = list((pool._processes or {}).values())
        pool.shutdown(wait=False, cancel_futures=True)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)


def family(n: int, seed: int, root_len: int = 300, lo: int = 270,
           hi: int = 330, clades: int = 16, letters: str = PROTEIN,
           subs=(0.12, 0.08), max_indel: int = 4, p_del: float = 0.5):
    """A family from a seed: a root sequence, clade ancestors with
    subs[0] substitutions and short indels (1..max_indel, a deletion with
    probability p_del), members with subs[1] more; lengths kept within
    [lo, hi].  The defaults give the protein family."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(letters.encode(), np.uint8)
    na = len(alpha)

    def mutate(seq, sub, n_indel):
        seq = seq.copy()
        mask = rng.random(len(seq)) < sub
        seq[mask] = alpha[rng.integers(0, na, int(mask.sum()))]
        for _ in range(n_indel):
            k = int(rng.integers(1, max_indel + 1))
            pos = int(rng.integers(0, len(seq)))
            if rng.random() < p_del and len(seq) - k >= lo:
                seq = np.delete(seq, slice(pos, pos + k))
            elif len(seq) + k <= hi:
                seq = np.insert(seq, pos, alpha[rng.integers(0, na, k)])
        return seq

    root = alpha[rng.integers(0, na, root_len)]
    anc = [mutate(root, subs[0], int(rng.poisson(3))) for _ in range(clades)]
    out = []
    for i in range(n):
        s = mutate(anc[i % clades], subs[1], int(rng.poisson(2)))
        out.append(s.tobytes().decode())
    return out


def long_family(seed: int, n_short: int = 3, long_len: int = 7300):
    """Short protein fragments and one long protein from a seed: a
    long_len-residue root taken whole with 5 % substitutions and a few
    short indels, and n_short fragments of 200-400 residues of one region
    of it at 10 % more.  Where the long sequence is a merge's column side,
    the merge is wider than 7,168 columns (the cluster row kernel's
    widths) while its rows stay short."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(PROTEIN.encode(), np.uint8)

    def mutate(seq, sub, n_indel):
        seq = seq.copy()
        mask = rng.random(len(seq)) < sub
        seq[mask] = alpha[rng.integers(0, len(alpha), int(mask.sum()))]
        for _ in range(n_indel):
            k = int(rng.integers(1, 4))
            pos = int(rng.integers(0, len(seq)))
            if rng.random() < 0.5:
                seq = np.delete(seq, slice(pos, pos + k))
            else:
                seq = np.insert(seq, pos, alpha[rng.integers(0, len(alpha),
                                                             k)])
        return seq

    root = alpha[rng.integers(0, len(alpha), long_len)]
    out = [mutate(root, 0.05, 8)]
    for _ in range(n_short):
        L = int(rng.integers(200, 401))
        s0 = int(rng.integers(3000, 3200))
        out.append(mutate(root[s0:s0 + L], 0.1, 2))
    return [s.tobytes().decode() for s in out]


def long_genomes(n: int = LONG_GENOMES_N, seed: int = 10):
    """HIV-1-length genomes from a seed: a 9,719-nt root, 16 clades at
    6 % substitutions, members at 3 % more, indels of 1-3 nt; lengths
    9,200-9,900, so every map DP and merge is wider than 7,168 columns
    (the cluster row kernel's widths)."""
    return family(n, seed, root_len=9719, lo=9200, hi=9900, letters=DNA,
                  subs=LONG_GENOMES_SUBS, max_indel=3)


def sars2_genomes(n: int = SARS2_N, seed: int = 15):
    """SARS-CoV-2-length genomes from a seed: a 29,903-nt root, 16 clades
    at 2 % substitutions, members at 1 % more, indels of 1-3 nt; lengths
    29,400-30,300 (every DP 7,296 to 114,688 columns wide: the cluster
    row kernel's)."""
    return family(n, seed, root_len=SARS2_LEN, lo=29400, hi=30300,
                  letters=DNA, subs=SARS2_SUBS, max_indel=3)


def plastome_genomes(n: int = PLASTOME_N, seed: int = 16):
    """Plastome-length genomes from a seed: a 155,943-nt root, 4 clades at
    3 % substitutions, members at 1.5 % more, indels of 1-3 nt; lengths
    150,000-160,000 (every DP past 114,688 columns: the wave route's)."""
    return family(n, seed, root_len=PLASTOME_LEN, lo=150000, hi=160000,
                  clades=4, letters=DNA, subs=PLASTOME_SUBS, max_indel=3)


def wide_family(n: int = WIDE_N, seed: int = 18):
    """The mesh_wide path's input from a seed: a WIDE_LEN-nt root taken
    whole with WIDE_SUBS[0] substitutions and a few indels of 1-3 nt, and
    n copies of its first WIDE_REGION nt at WIDE_SUBS[1] more."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(DNA.encode(), np.uint8)

    def mutate(seq, sub, n_indel):
        seq = seq.copy()
        mask = rng.random(len(seq)) < sub
        seq[mask] = alpha[rng.integers(0, len(alpha), int(mask.sum()))]
        for _ in range(n_indel):
            k = int(rng.integers(1, 4))
            pos = int(rng.integers(0, len(seq)))
            if rng.random() < 0.5:
                seq = np.delete(seq, slice(pos, pos + k))
            else:
                seq = np.insert(seq, pos, alpha[rng.integers(0, len(alpha),
                                                             k)])
        return seq

    root = alpha[rng.integers(0, len(alpha), WIDE_LEN)]
    out = [mutate(root, WIDE_SUBS[0], 20)]
    out += [mutate(root[:WIDE_REGION], WIDE_SUBS[1], 4) for _ in range(n)]
    return [s.tobytes().decode() for s in out]


def hcmv_genomes(n: int = HCMV_N, seed: int = 19):
    """Genomes of a large DNA virus's length from a seed: a 236,000-nt root
    (HCMV's ~236 kb), 4 clades at HCMV_SUBS[0] substitutions, members at
    HCMV_SUBS[1] more, indels of 1-3 nt; lengths 232,000-240,000.  One
    card holds a pairwise DP of them on the wave route (~60 GB), so
    gpu-fast on one card and gpu-mesh over the cards align the same
    family."""
    return family(n, seed, root_len=HCMV_LEN, lo=232000, hi=240000,
                  clades=4, letters=DNA, subs=HCMV_SUBS, max_indel=3)


def v4_family(n: int, seed: int):
    """16S rRNA V4-like amplicon variants (the 515F/806R region, ~253 nt):
    a 253-nt root, 16 clades at 8 % substitutions, members at 4 % more,
    indels of 1-3 nt biased to deletions; lengths 240-270."""
    return family(n, seed, root_len=253, lo=240, hi=270, letters=DNA,
                  subs=(0.08, 0.04), max_indel=3, p_del=0.6)


def ptxas_lines(log: str, entry: str = ""):
    """`nvcc -Xptxas -v`'s lines (entry, stack frame and spills,
    registers) of the kernels whose mangled names hold ``entry``."""
    out, keep = [], False
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            keep = entry in ln
        if keep and ("registers" in ln or "spill" in ln
                     or "Compiling entry" in ln):
            out.append(ln.strip())
    return out


# ---------------------------------------------------------------------------
def phase_device_and_build():
    import torch
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    from kalign_tpu_torch import native
    from kalign_tpu_torch.gpu import _cuda
    from kalign_tpu_torch.utils.build import build_log
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:
        f_cuda = ex.submit(_cuda.library_path)
        f_tree = ex.submit(native.library_path)
        f_probe = ex.submit(_cuda.library_path, "libkt_probe", [PROBE_SRC],
                            [])
        cuda_path, tree_path = f_cuda.result(), f_tree.result()
        f_probe.result()
    secs = time.perf_counter() - t0
    _cuda.lib()
    native.lib()
    ptxas = ptxas_lines(build_log(cuda_path))
    emit({"phase": "build", "seconds": round(secs, 3),
          "cuda_lib": os.path.relpath(cuda_path, HERE),
          "native_lib": os.path.relpath(tree_path, HERE), "ptxas": ptxas})
    return smi


def dp_problem(rng, L1p, L2p, la, lb, dev):
    """Random match scores and dyadic penalties for problems of lengths
    (la, lb) padded to L1p x L2p, centering bias on (eps 1e-3)."""
    import torch
    B = len(la)
    match = rng.standard_normal((B, L1p, L2p), dtype=np.float32) * 3
    pc = (-rng.integers(16, 96, size=(B, 3, L2p + 1)) / 32).astype(np.float32)
    pr = (-rng.integers(16, 96, size=(B, 3, L1p + 1)) / 32).astype(np.float32)
    la = np.asarray(la, np.int32)
    lb = np.asarray(lb, np.int32)
    slope = (lb / np.maximum(la, 1)).astype(np.float32)
    eps = np.full(B, 1e-3, np.float32)
    t = lambda x: torch.from_numpy(x).to(dev)
    return dict(match=t(match), pc=t(pc), pr=t(pr), la=t(la), lb=t(lb),
                slope=t(slope), eps=t(eps), L1p=L1p, L2p=L2p)


def dp_args(p):
    return (p["match"], p["pc"], p["pr"], p["la"], p["lb"], p["slope"],
            p["eps"])


def valid_region_equal(dec_a, dec_b, la, lb):
    """Decisions equal on every problem's rows < la, columns < lb."""
    import torch
    B, L1p, L2p = dec_a.shape
    rows = torch.arange(L1p, device=dec_a.device)[None, :, None]
    cols = torch.arange(L2p, device=dec_a.device)[None, None, :]
    mask = (rows < la[:, None, None]) & (cols < lb[:, None, None])
    return bool(torch.equal(dec_a[mask], dec_b[mask]))


def dec_cells(lanewise, dec, L2p):
    from kalign_tpu_torch.gpu import gotoh_lanewise
    return gotoh_lanewise.unpack_dec(dec, L2p) if lanewise else dec


# largest |kernel - plain| seen per kernel over every comparison
MAX_ABS_ERR = {}


def hold(name: str, ok: bool, err: float, what: str):
    """Record a comparison; raise unless the kernel matched."""
    MAX_ABS_ERR[name] = max(MAX_ABS_ERR.get(name, 0.0), err)
    if not ok:
        raise AssertionError(f"{name} {what}: the kernel disagrees with "
                             f"its plain version (max abs err {err})")


def abs_err(a, b) -> float:
    import torch
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def hold_dp_outputs(name, lanewise, a, b, p, what):
    """Bitwise scores, equal end states and valid-region decisions."""
    import torch
    (da, sa, sta), (db, sb, stb) = a, b
    ok = (torch.equal(sa.view(torch.int32), sb.view(torch.int32))
          and torch.equal(sta, stb)
          and valid_region_equal(dec_cells(lanewise, da, p["L2p"]),
                                 dec_cells(lanewise, db, p["L2p"]),
                                 p["la"], p["lb"]))
    hold(name, ok, abs_err(sa, sb), what)


def hold_walks(a, b, la, lb, what, whole=True):
    """Identical steps and counts; unless max_steps cut them (whole=False),
    each walk consumes la rows and lb columns."""
    import torch
    (sa, na), (sb, nb) = a, b
    ok = torch.equal(sa, sb) and torch.equal(na, nb)
    if whole:
        ok = (ok and torch.equal(((sa == 0) | (sa == 2)).sum(1).int(), la)
              and torch.equal(((sa == 0) | (sa == 1)).sum(1).int(), lb))
    hold("traceback", ok, max(abs_err(sa, sb), abs_err(na, nb)), what)


def walk_decisions(rng, B, L1p, L2p, p_diag, p_ext):
    """Random decision bytes [B, L1p, L2p] (numpy int8): the next state
    from A is the diagonal with probability p_diag, else GA or GB; the gap
    states extend with probability p_ext.  Near-diagonal walks cross the
    walk's windows through their tops, gap-heavy ones through both edges."""
    shape = (B, L1p, L2p)
    a = np.where(rng.random(shape, dtype=np.float32) < p_diag, 0,
                 rng.integers(1, 3, shape, dtype=np.int8))
    ga = rng.random(shape, dtype=np.float32) < p_ext
    gb = rng.random(shape, dtype=np.float32) < p_ext
    return (a | (ga << 2) | (gb << 3)).astype(np.int8)


def hold_walk_case(dev, rng, lanewise, B, L1p, L2p, p_diag, p_ext, la, lb,
                   max_steps=None):
    """The walk kernel against its plain version on random decisions with
    lengths la, lb (B of them) and random end states."""
    import torch
    from kalign_tpu_torch.gpu import gotoh_lanewise
    from kalign_tpu_torch.gpu import traceback as tb
    dec = torch.from_numpy(walk_decisions(rng, B, L1p, L2p, p_diag,
                                          p_ext)).to(dev)
    if lanewise:
        dec = gotoh_lanewise.pack_dec(dec)
    t = lambda x: torch.from_numpy(np.asarray(x, np.int32)).to(dev)
    st = t(rng.integers(0, 3, size=B))
    la, lb = t(la), t(lb)
    ms = max_steps or L1p + L2p + 2
    walk, plain = ((tb.walk_lanewise, tb.plain_lanewise) if lanewise
                   else (tb.walk_rows, tb.plain_rows))
    hold_walks_later(walk(dec, la, lb, st, ms), plain,
                     (dec, la, lb, st, ms),
                     f"{walk.__name__} {B}x{L1p}x{L2p} p_diag={p_diag} "
                     f"p_ext={p_ext} max_steps={ms}",
                     whole=max_steps is None)


def hold_walks_later(got, plain, args, what, whole=True):
    """hold_walks of the walk kernel's got against plain(*args), run in a
    host worker (later)."""
    got = tuple(x.cpu() for x in got)
    la, lb = args[1].cpu(), args[2].cpu()
    later(plain, args, lambda ref, ms: hold_walks(
        got, ref, la, lb, f"{what}, plain version on the CPU", whole))


def hold_dp_later(name, lanewise, out, plain, args, p, what, done=None):
    """hold_dp_outputs of a DP kernel's outputs out against plain(*args),
    run in a host worker (later); then done(the plain version's wall ms),
    where given."""
    out = tuple(x.cpu() for x in out)
    pc = dict(la=p["la"].cpu(), lb=p["lb"].cpu(), L2p=p["L2p"])

    def check(ref, ms):
        hold_dp_outputs(name, lanewise, out, ref, pc,
                        f"{what}, plain version on the CPU")
        if done is not None:
            done(ms)
    later(plain, args, check)


def hold_equal(name, a, b, what):
    import torch
    hold(name, torch.equal(a, b), abs_err(a, b), what)


def hold_equal_later(name, got, plain, args, what):
    """hold_equal of a kernel's output got against plain(*args), run in a
    host worker (later)."""
    got = got.cpu()
    later(plain, args, lambda ref, ms: hold_equal(
        name, got, ref, f"{what}, plain version on the CPU"))


def phase_edge_cases(dev):
    """Each kernel against its plain version on small and degenerate
    inputs (the wrappers' full function, lb == 0 fix-up included)."""
    import torch
    from kalign_tpu_torch.gpu import gotoh_fused, gotoh_lanewise, gotoh_row, \
        scan
    from kalign_tpu_torch.gpu import traceback as tb
    rng = np.random.default_rng(0)

    # row Gotoh: B=64 at 384 x 384, with la=0, lb=0 and lb=L2p problems,
    # under every block size (2, 4 and 8 columns per thread); B=4 at
    # 256 x 2176, whose last block columns lie past L2p
    la = rng.integers(1, 385, size=64)
    lb = rng.integers(1, 385, size=64)
    la[[0, 2]] = 0
    lb[[1, 2]] = 0
    lb[3] = 384
    p = dp_problem(rng, 384, 384, la, lb, dev)
    row_k = gotoh_row.forward(*dp_args(p))
    row_ref = gotoh_row.forward_plain(*dp_args(p))
    hold_dp_outputs("gotoh_row", False, row_k, row_ref, p,
                    "64x384x384 with la=0/lb=0")
    for ch in gotoh_row.CHUNKS:
        cfg = gotoh_row.config_for(384, ch)
        hold_dp_outputs("gotoh_row", False, gotoh_row.run_dp(
            gotoh_row.prepare,
            lambda *a: gotoh_row.launch(*a, config=cfg), *dp_args(p)),
            row_ref, p, f"64x384x384 under {cfg}")
    la = rng.integers(1, 257, size=4)
    lb = rng.integers(1, 2177, size=4)
    la[0], lb[1], lb[2] = 0, 0, 2176
    w = dp_problem(rng, 256, 2176, la, lb, dev)
    hold_dp_outputs("gotoh_row", False, gotoh_row.forward(*dp_args(w)),
                    gotoh_row.forward_plain(*dp_args(w)), w,
                    f"4x256x2176 under {gotoh_row.launch_config(4, 2176)}")
    edge_cases_cluster(dev, rng, p, row_ref)
    edge_cases_wave(dev, rng, p, row_ref)
    edge_cases_prepare(dev, rng)

    # lanewise Gotoh: B=1024 at 128 x 128, lengths 1..128 and 0
    la = rng.integers(1, 129, size=1024)
    lb = rng.integers(1, 129, size=1024)
    la[[3, 5]] = 0
    lb[[4, 5]] = 0
    q = dp_problem(rng, 128, 128, la, lb, dev)
    lw_k = gotoh_lanewise.forward(*dp_args(q))
    hold_dp_later("gotoh_lanewise", True, lw_k, gotoh_lanewise.forward_plain,
                  dp_args(q), q, "1024x128x128 with la=0/lb=0")

    # lanewise Gotoh with rows past a strip of 32 x R rows: B=64 at
    # 136 x 16, with la=0/lb=0 problems
    la = rng.integers(1, 137, size=64)
    lb = rng.integers(1, 17, size=64)
    la[[3, 5]] = 0
    lb[[4, 5]] = 0
    la[6] = 136
    q2 = dp_problem(rng, 136, 16, la, lb, dev)
    hold_dp_later("gotoh_lanewise", True,
                  gotoh_lanewise.forward(*dp_args(q2)),
                  gotoh_lanewise.forward_plain, dp_args(q2), q2,
                  "64x136x16 with la=0/lb=0")

    # fused Gotoh: la=0/lb=0 problems, operands of any float value (the
    # chain's order is the plain version's): nc=5 at 128 x 128 and nc=23
    # at 64 x 64 (B=1024), nc=1 at 136 x 16 (rows past a 128-row strip),
    # nc=8 at 72 x 8 (one decision word per row), nc=32 at 40 x 24 (the
    # widest operand rows, one row per lane)
    for nc, B, L1, L2 in ((5, 1024, 128, 128), (23, 1024, 64, 64),
                          (1, 64, 136, 16), (8, 64, 72, 8),
                          (32, 64, 40, 24)):
        la = rng.integers(1, L1 + 1, size=B)
        lb = rng.integers(1, L2 + 1, size=B)
        la[[3, 5]] = 0
        lb[[4, 5]] = 0
        lb[6] = L2
        f = dp_problem(rng, L1, L2, la, lb, dev)
        ops = [torch.from_numpy(rng.standard_normal(
            (B, L, nc), dtype=np.float32)).to(dev) for L in (L1, L2)]
        args = (*ops, *dp_args(f)[1:])
        hold_dp_later("gotoh_fused", True, gotoh_fused.forward(*args),
                      gotoh_fused.forward_plain, args, f,
                      f"{B}x{L1}x{L2} nc={nc} with la=0/lb=0")

    # traceback over both decision layouts: the forward kernels' own
    # decisions, then random decisions whose walks cross many windows
    # (tb.WINDOW) through their tops (near-diagonal) and left edges
    # (gap-heavy), pure-gap walks (la = 0, lb = 0, lb = L2p), lengths
    # just past a window edge, a max_steps shorter than la + lb, and
    # walks longer than the step buffer
    for walk, plain, r, (dec, _, st) in (
            (tb.walk_rows, tb.plain_rows, p, row_k),
            (tb.walk_lanewise, tb.plain_lanewise, q, lw_k)):
        args = (dec, r["la"], r["lb"], st, r["L1p"] + r["L2p"] + 2)
        hold_walks_later(walk(*args), plain, args,
                         f"{walk.__name__} {tuple(dec.shape)}")
    for lanewise in (False, True):
        win = tb.WINDOW[0]
        la = rng.integers(300, 513, size=64)
        lb = rng.integers(300, 513, size=64)
        la[0], lb[1], lb[2] = 0, 0, 512
        la[3:6], lb[3:6] = (win + 1, win, 1), (win + 1, win + 1, win + 2)
        la[6], lb[6] = 2 * win + 1, 3 * win + 1
        for p_diag, p_ext in ((0.9, 0.5), (0.2, 0.9)):
            hold_walk_case(dev, rng, lanewise, 64, 512, 512, p_diag, p_ext,
                           la, lb)
        hold_walk_case(dev, rng, lanewise, 64, 512, 512, 0.5, 0.7, la, lb,
                       max_steps=300)
        L = 3072 if not lanewise else 2560
        hold_walk_case(dev, rng, lanewise, 4, L, L, 0.6, 0.7,
                       [L, L - 1, L // 2, 0], [L, L - 7, L, L])

    # prefix sums: strided views of R = 1, 33, 1000 rows (not multiples
    # of a block's rows) and W = 1, 129, 1408 columns (one column, past a
    # column tile), one at a time and three sets in one launch
    x = torch.from_numpy(rng.standard_normal((1000, 3, 1409),
                                             dtype=np.float32)).to(dev)
    views = [x[:R, k % 3, 1:W + 1] for k, (R, W) in enumerate(
        (R, W) for R in (1, 33, 1000) for W in (1, 129, 1408))]
    for v in views + [x[:3, 0, :]]:
        hold_equal("prefix_sum", scan.prefix_sum_f32(v), scan.plain(v),
                   str(tuple(v.shape)))
    sets = (views[8], views[4], views[0])
    for got, v in zip(scan.prefix_sums_f32(*sets), sets):
        hold_equal("prefix_sum", got, scan.plain(v),
                   f"{tuple(v.shape)} of three sets in one launch")

    edge_cases_bpm(dev, rng)
    edge_cases_tree_pairs(dev)
    emit({"phase": "edge_cases", "ok": True})


def cluster_cases(dev, rng):
    """The cluster row kernel's edge problems: 1 x 128 x 7,296 (the
    narrowest width it takes); 8 x 512 x 8,192 with full and short la /
    lb, lb = 0 and la = 0, lb at band edges (512, 4,096) and one either
    side; the same with la / lb at full length; 2 x 256 x 16,384; 1 x 64 x
    114,688 (the widest, 16 bands of 7,168)."""
    return [dp_problem(rng, 128, 7296, [128], [7296], dev),
            dp_problem(rng, 512, 8192, [512, 300, 0, 512, 1, 511, 200, 512],
                       [8192, 512, 5000, 0, 8192, 513, 4096, 4095], dev),
            dp_problem(rng, 512, 8192, [512] * 8, [8192] * 8, dev),
            dp_problem(rng, 256, 16384, [256, 100], [16384, 9000], dev),
            dp_problem(rng, 64, 114688, [64], [114687], dev)]


def hold_twice(name, run, ref, p, what):
    """A kernel launched twice: each launch bitwise equal to the plain
    outputs ref (so to each other)."""
    for k in range(2):
        hold_dp_outputs(name, False, run(), ref, p, f"{what}, launch {k}")


def edge_cases_cluster(dev, rng, p, ref):
    """The cluster row kernel against the plain version at its edge widths
    (cluster_cases) under its plan, and the 8,192-wide problems also under
    clusters of 2, 4, 8 and 16 blocks; on the 64 x 384 x 384 problem p
    (plain outputs ref) under 3 bands of 128 and 4 (the last band wholly
    past the row); each launch twice."""
    from kalign_tpu_torch.gpu import gotoh_row
    for w in cluster_cases(dev, rng):
        B, W = len(w["la"]), w["L2p"]
        cfg = gotoh_row.launch_config(B, W)
        if cfg.route != "cluster":
            raise AssertionError(f"{shape_of(w)}: not the cluster plan")
        plain = gotoh_row.forward_plain(*dp_args(w))
        cfgs = [cfg] + ([gotoh_row.cluster_config(B, W, blocks=s)
                         for s in gotoh_row.CLUSTER_SIZES] if W == 8192
                        else [])
        for c in cfgs:
            hold_twice("gotoh_row_cluster", lambda: gotoh_row.run_dp(
                gotoh_row.prepare, lambda *a: gotoh_row.launch(*a, config=c),
                *dp_args(w)), plain, w, f"{shape_of(w)} under {c}")
        emit({"phase": "edge_cluster", "shape": shape_of(w),
              "plan": cfg._asdict(),
              "max_active_clusters": gotoh_row.cluster_schedulable(cfg)})
    for c in (gotoh_row.band_config(3, 128, 4),
              gotoh_row.band_config(4, 128, 4)):
        hold_twice("gotoh_row_cluster", lambda: gotoh_row.run_dp(
            gotoh_row.prepare, lambda *a: gotoh_row.launch(*a, config=c),
            *dp_args(p)), ref, p, f"64x384x384 under {c}")


def wave_plan(blocks, band, bands, ch=4):
    """A WaveLaunch of ``bands`` clusters of ``blocks`` blocks of ``band``
    columns, ch a thread, with the shared memory wave_config gives it."""
    from kalign_tpu_torch.gpu import gotoh_row
    threads = band // ch
    return gotoh_row.WaveLaunch(
        "wave", threads, ch, max(gotoh_row.wave_smem_bytes(threads, ch),
                                 gotoh_row.WAVE_SMEM_MIN), blocks, band,
        bands)


def wave_dp(plan=None, rows=None):
    """dp_fn of gotoh_row.run_dp through the wave kernel, under a forced
    plan and rows a launch where given."""
    from kalign_tpu_torch.gpu import gotoh_wave

    def run(m, prep, la, lb):
        return gotoh_wave.launch(lambda b, r0, r1, out=None: m[b, r0:r1],
                                 prep, la, lb, plan, rows)
    return run


def edge_cases_wave(dev, rng, p, ref):
    """The wave route (csrc/gotoh_row_wave.cu) against the plain row DP on
    the same card tensors, each launch twice: 1 x 64 x 131,072 and 1 x 64
    x 114,816 (the narrowest width it takes) under launch_config's plan,
    in one launch; 4 x 64 x 131,072 with lb at a band's edge (8,192) and
    one either side, la < L1p, la = 1, la = 0; 2 x 100 x 131,072 in
    launches of 16 and 33 rows (several blocks of rows, the state carried);
    and the 64 x 384 x 384 problem p (plain outputs ref; la = 0 and lb = 0
    among them) under forced plans: 3 clusters of one block of 128
    columns, one cluster of 3, 2 of 2 (the last block past the row), in
    launches of 16 rows and of all rows."""
    from kalign_tpu_torch.gpu import gotoh_row

    def held(w, dp, what):
        plain = gotoh_row.forward_plain(*dp_args(w))
        hold_twice("gotoh_row_wave", lambda: gotoh_row.run_dp(
            gotoh_row.prepare, dp, *dp_args(w)), plain, w, what)

    for w in (dp_problem(rng, 64, 131072, [64], [131000], dev),
              dp_problem(rng, 64, 114816, [64], [114816], dev)):
        cfg = gotoh_row.launch_config(1, w["L2p"])
        if cfg.route != "wave":
            raise AssertionError(f"{shape_of(w)}: not the wave plan")
        held(w, gotoh_row.launch, f"{shape_of(w)} under {cfg}")
        emit({"phase": "edge_wave", "shape": shape_of(w),
              "plan": cfg._asdict()})
    w = dp_problem(rng, 64, 131072, [64, 33, 1, 0], [8192, 8191, 8193, 65536],
                   dev)
    held(w, gotoh_row.launch, f"{shape_of(w)}, lb at a band's edge")
    w = dp_problem(rng, 100, 131072, [100, 70], [131072, 100000], dev)
    for rows in (16, 33):
        held(w, wave_dp(rows=rows), f"{shape_of(w)}, {rows} rows a launch")
    for plan in (wave_plan(1, 128, 3), wave_plan(3, 128, 1),
                 wave_plan(2, 128, 2)):
        for rows in (16, None):
            hold_twice("gotoh_row_wave", lambda: gotoh_row.run_dp(
                gotoh_row.prepare, wave_dp(plan, rows), *dp_args(p)), ref,
                p, f"64x384x384 under {plan}, rows a launch {rows}")


def hold_bits(name, got, want, what):
    """float32 tensors equal bit for bit."""
    import torch
    hold(name, torch.equal(got.view(torch.int32), want.view(torch.int32)),
         abs_err(got, want), what)


def bonus_block(rng, B, R, W, K, dev, dead_rows=0):
    """Random anchor vectors of a block (positions -1..11, the first
    dead_rows rows of every anchor at -1) and per_w."""
    import torch
    t = lambda x: torch.from_numpy(x).to(dev)
    apr = rng.integers(-1, 12, (B, K, R)).astype(np.int32)
    apr[:, :, :dead_rows] = -1
    return (torch.tensor(np.float32(2.0 / max(K, 1)), device=dev), t(apr),
            t(rng.random((B, K, R), dtype=np.float32)),
            t(rng.integers(-1, 12, (B, K, W)).astype(np.int32)),
            t(rng.random((B, K, W), dtype=np.float32)))


# the match preparation's edge cases: (B, R, W, K, row0, col0, dead
# rows): W past a tile and not a multiple of it, K across the
# compile-time instantiations (0, 1, 5) and the groups of 8 (9, 16), rows
# whose anchors are all -1, row0 / col0 offsets, B = 1 and B = 8, tiles
# of 32 and 128 threads across (W = 8, 384)
PREPARE_EDGE = [(1, 70, 1028, 5, 100, 384, 7),
                (8, 33, 2052, 1, 0, 0, 0),
                (8, 64, 640, 0, 3, 5, 0),
                (2, 50, 4100, 9, 7, 1024, 3),
                (3, 17, 384, 16, 0, 0, 17),
                (1, 300, 12292, 5, 0, 0, 40),
                (8, 5, 8, 5, 11, 13, 0),
                (4, 8, 2048, 1, 7, 1024, 2)]


def edge_cases_prepare(dev, rng):
    """The match-preparation kernel (csrc/prepare_match.cu, in place)
    against its plain version (prepare.bonus_match) on the same card
    tensors, bitwise, at PREPARE_EDGE (la = 0 and lb = 0 problems among
    them), each under its launch plan (prepare.launch_plan)."""
    import torch
    from kalign_tpu_torch.gpu import prepare
    for B, R, W, K, row0, col0, dead in PREPARE_EDGE:
        match = torch.from_numpy(rng.standard_normal(
            (B, R, W), dtype=np.float32) * 3).to(dev)
        la = torch.from_numpy(rng.integers(
            0, row0 + R + 1, B).astype(np.int32)).to(dev)
        lb = torch.from_numpy(rng.integers(
            0, col0 + W + 1, B).astype(np.int32)).to(dev)
        la[0], lb[-1] = 0, 0
        eps = torch.full((B,), 1e-3, device=dev)
        bonus = bonus_block(rng, B, R, W, K, dev, dead)
        want = prepare.bonus_match(match, la, lb, eps, bonus, col0, row0)
        got = prepare.prepare_match(match.clone(), la, lb, eps, bonus, col0,
                                    row0)
        plan = prepare.launch_plan(B, R, W)
        hold_bits("prepare_match", got, want,
                  f"{B}x{R}x{W} K={K} at row0={row0}, col0={col0}, "
                  f"{dead} dead rows, tiles of {plan.tx * 4} x {plan.rows}")


def random_tokens(rng, lens):
    """Rows of random codes 0..12, zero past each length."""
    tokens = np.zeros((len(lens), max(1, int(max(lens)))), np.uint8)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(0, 13, size=n)
    return tokens


def edge_cases_bpm(dev, rng):
    """BPM and its mask-table kernel against their plain versions: every
    instantiation (nblk 1..16) on pairs whose patterns need nblk blocks,
    with m = 0, 1, 63, 64, 65, 64*nblk - 1 and 64*nblk where they fit,
    texts of length 0, equal to the pattern and (nblk 1 and 16) past
    1,024, a P that is no multiple of a block's threads and P = 1; then
    2,048 sequences x 32 anchors through distances.PairBatch, lengths
    60-1,100 (plain versions on CPU copies: later)."""
    import torch
    from kalign_tpu_torch.gpu import bpm, distances
    for nblk in range(1, bpm.NBLK + 1):
        width = bpm.WORD * nblk
        longest = 1100 if nblk in (1, bpm.NBLK) else width + 40
        lens = [x for x in (0, 1, 63, 64, 65, width - 1, width)
                if x <= width]
        lens += [longest, width + 1] + list(rng.integers(
            width - bpm.WORD + 1, width + 1, size=12))
        lens += list(rng.integers(1, longest + 1, size=20))
        lens = np.array(lens, np.int32)
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        tokens = random_tokens(rng, lens)
        tok = t(np.pad(tokens, ((0, 0), (0, -tokens.shape[1] % 16))))
        m_seq = t(np.minimum(lens, bpm.MAX_PATTERN).astype(np.int32))
        table = bpm.build_table(tok, m_seq, nblk)
        hold_equal_later("bpm_table", table, bpm.plain_table,
                         (tok, m_seq, nblk), f"nblk={nblk}, {len(lens)} rows")
        N = len(lens)
        P = 300 + nblk
        ti = rng.integers(0, N, size=P).astype(np.int32)
        pi = rng.integers(0, N, size=P).astype(np.int32)
        ti[:N], pi[:N] = np.arange(N), np.arange(N)          # text = pattern
        pi[N:2 * N] = np.arange(N)                           # every pattern
        inp = (tok, t(ti), t(pi), t(lens[ti]), m_seq[t(pi).long()], table)
        one = slice(N + 1, N + 2)           # P = 1 (pairs are independent)
        hold_equal_later("bpm", bpm.bpm_batch(*inp), bpm.plain, inp,
                         f"nblk={nblk}, P={P}")
        inp1 = (tok, *(x[one] for x in inp[1:5]), table)
        hold_equal_later("bpm", bpm.bpm_batch(*inp1), bpm.plain, inp1,
                         f"nblk={nblk}, P=1")

    N = 2048
    lens = rng.integers(60, 1101, size=N).astype(np.int32)
    anchors = list(range(0, N, N // 32))
    pairs = distances.PairBatch(random_tokens(rng, lens), lens,
                                *distances.anchor_pairs(N, anchors), dev)
    inp = pairs.inputs(0, pairs.n_pairs)
    hold_equal_later("bpm", bpm.bpm_batch(*inp), bpm.plain, inp,
                     "2048x32, lengths 60-1100")


def edge_cases_tree_pairs(dev):
    """The guide tree's leaf-set pair distances in one batch on the BPM
    kernel (distances.leaf_distances) bitwise against the native tree's
    own loop (native.leaf_distances) on the sars2_default path's family,
    its tree's inputs made as align_msa makes them on the card; GpuEngine's
    tree byte-equal to the native tree's alone.  Both timed once, the
    kernels already built."""
    from kalign_tpu_torch import engine as TE
    from kalign_tpu_torch import native
    from kalign_tpu_torch.core import alphabet as alpha
    from kalign_tpu_torch.core.msa import Msa
    from kalign_tpu_torch.gpu import distances
    from kalign_tpu_torch.gpu.engine import GpuEngine
    msa = Msa.from_sequences(sars2_genomes())
    msa.quiet = True
    msa.sort_len_name()
    TE._encoded(msa, alpha.ALPHA_DEFAULT_DNA)
    anchors = TE.pick_anchors(msa)
    codes = [sq.s for sq in msa.sequences]
    dm = distances.anchor_distances(codes, anchors, dev)
    shape, members, _ = native.tree_leaf_sets(dm, len(anchors))
    sets = native.leaf_sets(shape, members)
    (got, pairs), batch_ms = timed_once(
        lambda: distances.leaf_distances(codes, sets, dev))
    t0 = time.perf_counter()
    want = np.concatenate([native.leaf_distances(codes, s).reshape(-1)
                           for s in sets])
    native_ms = (time.perf_counter() - t0) * 1e3
    err = float(np.abs(got.astype(np.float64) - want).max())
    hold("bpm", got.tobytes() == want.tobytes(), err,
         f"leaf sets {[len(s) for s in sets]} of SARS2_N genomes")
    tasks, sd = GpuEngine(dev).build_tree(codes, dm, len(anchors))
    want_tasks, want_sd = native.build_tree(codes, dm, len(anchors))
    if tasks.tobytes() != want_tasks.tobytes() \
            or sd.tobytes() != want_sd.tobytes():
        raise AssertionError("GpuEngine.build_tree: the batch route's tree "
                             "differs from the native tree's")
    emit({"phase": "tree_pairs", "ok": True,
          "sets": [len(s) for s in sets], "pairs": pairs,
          "batch_ms": round(batch_ms, 3), "native_ms": round(native_ms, 3)})


# ---------------------------------------------------------------------------
def kmeans_plain_split(rows, form: int):
    """The plain versions' split of one cluster (all of rows [n, D]): form
    0 through lloyd_batch, form 1 through the fused recursion's first
    depth (plain_depth_split).  Returns (right [n] bool, degenerate, best
    SSE)."""
    import torch
    from kalign_tpu_torch.gpu import kmeans as K
    n, D = rows.shape
    dev = rows.device
    T = K.MAX_TRIES
    if form == 0:
        tries = min(T, n)
        seeds = torch.zeros((1, T), dtype=torch.int32, device=dev)
        seeds[0, :tries] = torch.arange(tries, device=dev) * (n // tries)
        ar = torch.arange(n, device=dev)[None]
        a, deg, sse = K.lloyd_batch(
            rows, ar.to(torch.int32), torch.ones_like(ar, dtype=torch.bool),
            (ar & 1).to(torch.int32), seeds,
            torch.tensor([tries], device=dev), T)
        right, deg, sse = a[0] == 1, bool(deg[0]), float(sse[0])
    else:
        Np = K._pow2_at_least(n)
        Ca = Np // K.UPGMA_THRESHOLD + 1
        emb = torch.zeros((Np, D), dtype=torch.float32, device=dev)
        emb[:n] = rows
        iota = torch.arange(Np, device=dev)
        cid = torch.where(iota < n, 1, K._PAD_CID).to(torch.int64)
        sg = K.segments(cid, iota >= n, iota, Np, Ca, T)
        r, d, sse_a = K.plain_depth_split(emb[sg["sidx"]], sg, Ca, T)
        right, deg, sse = r[:n], bool(d[0]), float(sse_a[0])
    if deg:
        right = torch.arange(n, device=dev) >= n // 2
    return right, deg, sse


def kmeans_kernel_split(rows, form: int):
    """The kernel's split of one cluster: (right, degenerate, best SSE,
    the launch's outputs)."""
    import torch
    from kalign_tpu_torch.gpu import kmeans as K
    n = rows.shape[0]
    dev = rows.device
    out = K.lloyd(rows, torch.zeros(1, dtype=torch.int32, device=dev),
                  torch.full((1,), n, dtype=torch.int32, device=dev), form)
    right, deg, sse = K.best_tries(*out[:3], torch.zeros(
        n, dtype=torch.int64, device=dev))
    deg = bool(deg[0])
    if deg:
        right = torch.arange(n, device=dev) >= n // 2
    return right, deg, float(sse[0]), out


def hold_kmeans_split(rows, form: int, what: str, identical_rows=False):
    """The kernel against its plain version on one cluster: the same
    split, or (a member within float noise of the tie boundary) the best
    tries' SSE equal to KMEANS_SSE_RTOL; twice the same bits. Rows all
    alike split on float noise (their distances are square roots of
    rounding errors), so there only a split into two nonempty sides is
    asked. Returns the case's record."""
    import torch
    right, deg, sse, out = kmeans_kernel_split(rows, form)
    again = kmeans_kernel_split(rows, form)[3]
    same_bits = all(torch.equal(a, b) for a, b in zip(out, again))
    hold("kmeans", same_bits, 0.0, f"{what}: two launches differ")
    p_right, p_deg, p_sse = kmeans_plain_split(rows, form)
    differ = int((right != p_right).sum())
    if identical_rows:
        n_right = int(right.sum())
        ok = 0 < n_right < len(right)
    else:
        ok = differ == 0 or abs(sse - p_sse) <= KMEANS_SSE_RTOL * abs(p_sse)
    hold("kmeans", ok, abs(sse - p_sse), what)
    return dict(case=what, n=rows.shape[0], D=rows.shape[1], form=form,
                rows_differ=differ, sse=sse, plain_sse=p_sse,
                degenerate=deg, plain_degenerate=p_deg,
                iters_max=int(out[3].max()))


def edge_cases_kmeans(dev, rng):
    """The Lloyd kernel against its plain versions in both forms: clusters
    of exactly 50, 51 and 2,048 rows, D = 5 anchors, rows that tie within
    EPS (two dyadic points and their midpoint: the midpoint's distances to
    the centroids differ by rounding only, so parity places them), and
    rows all alike."""
    import torch
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        dev)
    cases = []
    for n in (50, 51, 2048):
        rows = t(rng.random((n, 32)))
        for form in (0, 1):
            cases.append(hold_kmeans_split(rows, form,
                                           f"{n} x 32 form {form}"))
    cases.append(hold_kmeans_split(t(rng.random((300, 5))), 0,
                                   "300 x 5 form 0"))
    ties = np.concatenate([np.zeros((32, 4)), np.ones((32, 4)),
                           np.full((32, 4), 0.5)])[rng.permutation(96)]
    for form in (0, 1):
        cases.append(hold_kmeans_split(t(ties), form,
                                       f"96 x 4 ties form {form}"))
    cases.append(hold_kmeans_split(t(np.full((64, 32), 0.3)), 0,
                                   "64 x 32 all alike", identical_rows=True))
    emit({"phase": "edge_cases", "kernel": "kmeans", "cases": cases})


@contextmanager
def deterministic():
    """PyTorch's deterministic algorithms for the block: the plain k-means
    versions' segment sums (index_add_) add with atomics on the card, in
    an order that changes from run to run, and with them the splits
    that lie within float noise of a tie."""
    import torch
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def tree_inputs(seqs, dev):
    """The guide tree's inputs of an alignment of seqs, as align_msa makes
    them on the card: (codes, dm, anchors)."""
    from kalign_tpu_torch import engine as TE
    from kalign_tpu_torch.core import alphabet as alpha
    from kalign_tpu_torch.core.msa import Msa
    from kalign_tpu_torch.gpu import distances
    msa = Msa.from_sequences(seqs)
    msa.quiet = True
    msa.essential_input_check()
    if msa.aligned != 1:
        msa.dealign()
    msa.sort_len_name()
    TE._encoded(msa, alpha.ALPHA_REDUCED_PROTEIN)
    anchors = TE.pick_anchors(msa)
    codes = [sq.s for sq in msa.sequences]
    return codes, distances.anchor_distances(codes, anchors, dev), \
        len(anchors)


def phase_kmeans(dev, seqs):
    """The device tree at the large path's own input (its anchor distances
    on the card): each entry point through the kernel, twice (the same
    tasks: deterministic), and through its plain version on the card,
    which must give the same tasks or, where a split went otherwise, a
    first differing split whose best tries' SSE agree to KMEANS_SSE_RTOL
    (the number of splits made otherwise is reported); the native tree's
    seconds on the same input beside the device tree's; a fused run
    whose depth cap (lowered through its argument) is hit returns None.
    Then the kernel at its largest launch, the root split, timed beside
    its plain version (the fused form's first depth) and its bound."""
    import torch
    from kalign_tpu_torch import native
    from kalign_tpu_torch.gpu import kmeans as K
    from kalign_tpu_torch.utils.logging import recording
    codes, dm, na = tree_inputs(seqs, dev)
    n = len(codes)
    line = {"phase": "kmeans", "sequences": n, "anchors": na}
    _, ms = timed_once(lambda: native.build_tree(codes, dm, na))
    line["native_tree_s"] = ms / 1e3
    for entry, build in (("fused", K.build_tree_device_fused),
                         ("per_depth", K.build_tree_device)):
        launches0 = K.launches
        with recording(fresh=True) as rec:
            got, ms = timed_once(lambda: build(codes, dm, na, dev))
        split_s = {k + "_s": round(v, 4)
                   for k, v in rec.sums("tree.").items()}
        tr_k, tr_p = [], []
        again = build(codes, dm, na, dev, trace=tr_k)
        if got is None or again is None:
            raise AssertionError(f"kmeans {entry}: the depth cap was hit")
        hold("kmeans", np.array_equal(got[0], again[0]), 0.0,
             f"{entry} tree at {n} sequences: two runs differ")
        with deterministic():
            want, plain_ms = timed_once(lambda: build(
                codes, dm, na, dev, plain=True, trace=tr_p))
        same = np.array_equal(got[0], want[0])
        differ, first = K.compare_traces(tr_k, tr_p)
        ok = same or (first is not None and first[3] is not None and abs(
            first[2] - first[3]) <= KMEANS_SSE_RTOL * abs(first[3]))
        if not ok:
            emit({"phase": "kmeans", "entry": entry, "same_tasks": same,
                  "splits_made_otherwise": differ,
                  "first_split_otherwise": first})
        hold("kmeans", ok, 0.0 if first is None or first[3] is None
             else abs(first[2] - first[3]),
             f"{entry} tree at {n} sequences against the plain version")
        line[entry] = dict(
            device_tree_s=round(ms / 1e3, 4),
            device_tree_split_s=split_s,
            plain_tree_s=round(plain_ms / 1e3, 4), same_tasks=bool(same),
            splits=len(tr_k), splits_made_otherwise=differ,
            first_split_otherwise=first,
            launches=(K.launches - launches0) // 2,
            same_seq_dist=bool(np.array_equal(got[1], want[1])))
    line["depth_cap_2_returns_none"] = K.build_tree_device_fused(
        codes, dm, na, dev, depth_cap=2) is None
    if not line["depth_cap_2_returns_none"]:
        raise AssertionError("kmeans: a fused run at depth cap 2 returned "
                             "a tree")

    # the root split, the largest launch of the fused entry
    emb = torch.from_numpy(np.ascontiguousarray(
        dm[:, :na], np.float32)).to(dev)
    st = torch.zeros(1, dtype=torch.int32, device=dev)
    sz = torch.full((1,), n, dtype=torch.int32, device=dev)
    run = lambda: K.lloyd(emb, st, sz, form=1, max_size=n)
    out = run()
    _, plain_ms = timed_once(lambda: kmeans_plain_split(emb, 1))
    iters = out[3].double()
    ops = float(iters.sum()) * n * KMEANS_OPS(na)
    b_ms, b_by = bound(n * na * 4 + K.MAX_TRIES * (n + 9), ops,
                       FP32_OPS_PER_S)
    root = dict(shape=f"1 x {K.MAX_TRIES} x {n} x {na}",
                cluster_blocks=K.cluster_blocks(n),
                ms=cuda_time_ms(run, reps=5), device_ms=device_ms(run, 3),
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, iterations=[int(iters.min()),
                                             int(iters.max()),
                                             float(iters.mean())])
    line["root_split"] = root
    emit(line)
    return root


# ---------------------------------------------------------------------------
# the exact engine (engine "gpu"): its wavefront sweep kernel
def divergent_family(n: int, seed: int = 5):
    """The divergent path's input: the protein family with its divergence
    raised (DIVERGENT_SUBS) until its mean anchor distance lies in
    DIVERGENT_DISTANCE, so that gpu-fast routes it to the exact engine."""
    return family(n, seed, subs=DIVERGENT_SUBS)


@contextmanager
def sweep_capture(keep):
    """Every sweep launch of the exact engine inside the block is passed
    to keep(plans, key, live, kind) before it runs: kind "pairs" (the
    consistency pre-pass, residues x residues) or "merge m" with the
    operand modes m of its problems (0 residues x residues, 1 profile x
    residues, 2 profile x profile)."""
    from kalign_tpu_torch.gpu import exact as X
    run, build = X.Sweeper.run, X._plans
    seen = set()

    def build_rec(ops, w, *args):
        seen.update(["pairs"] if ops.kind == "pairs"
                    else (str(m) for m in ops.mode[w.p]))
        return build(ops, w, *args)

    def run_rec(self, plans, key, live):
        kind = ("pairs" if "pairs" in seen else
                "merge " + "".join(sorted(seen)))
        seen.clear()
        keep(plans, key, live, kind)
        return run(self, plans, key, live)
    X.Sweeper.run, X._plans = run_rec, build_rec
    try:
        yield
    finally:
        X.Sweeper.run, X._plans = run, build


def sweep_cells(plans, live) -> int:
    """Processed cells of a stacked plan below the live columns: per
    active row that is not an init row, its window's columns."""
    rows = plans["active"] & ~plans["is_init"]
    hi = np.minimum(plans["endq"], live[1] - 1).astype(np.int64)
    width = np.maximum(hi - plans["startq"] + 1, 0)
    return int(np.sum(np.where(rows, width, 0)))


def sweep_shape(plans, key, live):
    VR, C, _, chain = key
    return dict(grids=int(plans["seedA"].shape[0]), VR=VR, C=C,
                live=list(live), chain=bool(chain))


def sweep_tensors(plans, key, live, dev):
    """A captured plan on the card with the kernel's schedule computed
    on the host from its numpy rows (so that a launch does not wait on
    the card to compute it, as the engine's Sweeper does)."""
    import torch
    from kalign_tpu_torch.gpu import exact as X
    from kalign_tpu_torch.gpu import exact_sweep as XS
    lp = XS.launch_plan(key[0])
    lag, span = XS.schedule(plans, live[1], lp.threads * lp.rows)
    t = {k: X.on_device(v, dev) for k, v in plans.items()}
    t["lag"], t["span"] = (torch.from_numpy(x).to(dev) for x in (lag, span))
    return t


def hold_sweep(plans, key, live, what, dev):
    """The sweep kernel against its plain version on CPU copies of the
    same tensors (in a host worker: later): the live windows' outputs bit
    for bit, the -inf cells included.  Returns (the case's record, the
    CUDA plan)."""
    import torch
    from kalign_tpu_torch.gpu import exact_sweep as XS
    VR, C, Wmax, chain = key
    t = sweep_tensors(plans, key, live, dev)
    got = XS.launch(t, VR, C, Wmax, chain, *live).cpu()

    def check(ref, ms):
        ref = ref[:, :live[0], :live[1]].contiguous()
        same = torch.equal(got.view(torch.int32), ref.view(torch.int32))
        both = torch.isfinite(got) & torch.isfinite(ref)
        err = abs_err(got[both], ref[both]) if bool(both.any()) else 0.0
        if not torch.equal(torch.isfinite(got), torch.isfinite(ref)):
            err = float("inf")
        hold("exact_sweep", same, err, f"{what}, plain version on the CPU")
    later(XS.plain, (t, VR, C, Wmax, chain, XS.live_steps(VR, C, live[1])),
          check)
    return dict(case=what, **sweep_shape(plans, key, live),
                cells=sweep_cells(plans, live),
                finite_outputs=int(torch.isfinite(got).sum())), t


def sweep_edge_plans():
    """Plans of single windows at the edges of the sweep's cases, in
    residues x residues (match) and profile x profile (chain) form: a
    window of one row (and its edge flags init_tg, start_tg, end_tg all
    set: it spans every column), one of one column, one whose start is
    its end, one with init_tg and start_tg alone, one with end_tg alone,
    and all of them stacked in one grid."""
    from kalign_tpu_torch import native
    from kalign_tpu_torch.core import params as P
    from kalign_tpu_torch.gpu import exact as X
    rng = np.random.default_rng(3)
    ap = P.aln_param_init(P.BIOTYPE_PROTEIN, P.KALIGN_TYPE_PROTEIN,
                          -1.0, -1.0, -1.0, 1)
    subm = np.ascontiguousarray(ap.subm, np.float32)
    g = (np.float32(ap.gpo), np.float32(ap.gpe), np.float32(ap.tgpe))
    la, lb = 12, 10
    s1 = rng.integers(0, 23, la).astype(np.uint8)
    s2 = rng.integers(0, 23, lb).astype(np.uint8)

    def leaf(seq):
        out = np.zeros((len(seq) + 2) * 64, np.float32)
        native.lib().kt_leaf_profile(subm.reshape(-1), *g, seq, len(seq),
                                     out)
        return out
    Z, N = np.float32(0.0), X.NEG
    wins = {"one row": (0, 1, 0, 10), "one column": (3, 9, 4, 5),
            "start = end": (2, 6, 3, 3),
            "init_tg and start_tg": (0, 4, 0, 4), "end_tg": (5, 8, 6, 10)}
    out = []
    for mode, form in ((0, "match"), (2, "chain")):
        if mode == 0:
            aln = X.ExactAligner(0, s1, s2, None, None, la, lb, 0, subm,
                                 *g, np.float32(0.5), None)
        else:
            aln = X.ExactAligner(2, None, None, leaf(s1), leaf(s2), la, lb,
                                 0, None, *g, np.float32(0.0), None)
        aln.VR = aln.Wmax = 64
        key = (aln.VR, aln.Cpad, aln.Wmax, aln.use_chain)
        every = []
        for what, (sa, ea, sb, eb) in wins.items():
            w = (sa, ea, sb, eb, (Z, N, N), (N, N, Z))
            every.append((sa, ea, sb, eb, (N, Z, N), (Z, N, N)))
            out.append((f"{what} ({form})", aln.plans([w]), key,
                        (1, lb + 1)))
        out.append((f"all windows in one grid ({form})",
                    aln.plans(every), key, (len(every), lb + 1)))
    return out


def tall_window_cases(dev):
    """The sweep's strips: for each of TALL_WINDOWS, one
    window of random residues (or their leaf profiles in chain form) over
    TALL_LB columns, its first launch held bitwise against the plain
    version, then the whole recursion on the card against the native
    oracle (kt_run_align_single: the same path, margin sum and count)."""
    from kalign_tpu_torch import native
    from kalign_tpu_torch.core import params as P
    from kalign_tpu_torch.gpu import exact as X
    from kalign_tpu_torch.gpu import exact_sweep as XS
    L = native.lib()
    rng = np.random.default_rng(11)
    ap = P.aln_param_init(P.BIOTYPE_PROTEIN, P.KALIGN_TYPE_PROTEIN,
                          -1.0, -1.0, -1.0, 1)
    subm = np.ascontiguousarray(ap.subm.astype(np.float32).reshape(-1))
    g = (np.float32(ap.gpo), np.float32(ap.gpe), np.float32(ap.tgpe))

    def leaf(seq):
        out = np.zeros((len(seq) + 2) * 64, np.float32)
        L.kt_leaf_profile(subm, *g, seq, len(seq), out)
        return out
    Z, N = np.float32(0.0), X.NEG
    cases = []
    for la, mode in TALL_WINDOWS:
        lb = TALL_LB
        s1 = rng.integers(0, 23, la).astype(np.uint8)
        s2 = rng.integers(0, 23, lb).astype(np.uint8)
        if mode == 0:
            ops = (s1, s2, None, None)
            ptrs = (s1.ctypes.data, s2.ctypes.data, None, None)
        else:
            p1, p2 = leaf(s1), leaf(s2)
            ops = (None, None, p1, p2)
            ptrs = (None, None, p1.ctypes.data, p2.ctypes.data)
        sweeper = X.Sweeper(dev)
        aln = X.ExactAligner(mode, *ops, la, lb, 0,
                             subm.reshape(23, 23) if mode == 0 else None,
                             *g, np.float32(0.0), None, sweeper=sweeper)
        top = (0, la, 0, lb, (Z, N, N), (Z, N, N))
        key = (aln.VR, aln.Cpad, aln.Wmax, aln.use_chain)
        form = "chain" if mode == 2 else "match"
        rec, _ = hold_sweep(aln.plans([top]), key, (1, lb + 1),
                            f"tall window {la} x {lb} ({form})", dev)
        path = np.full(la + 2, -1, np.int32)
        msum, mcount, _ = aln.run(path)
        ref = np.full(la + 2, -1, np.int32)
        info = np.zeros(3, np.float32)
        L.kt_run_align_single(mode, *ptrs, la, lb, 0, subm, *g,
                              np.float32(0.0), None, lb, 0.0, 0, 1, 0, ref,
                              info)
        same = (np.array_equal(ref, path) and np.float32(msum) == info[0]
                and mcount == int(info[1]))
        hold("exact_sweep", same, 0.0 if same else float("inf"),
             f"tall window {la} x {lb} ({form}): the whole recursion "
             "against the native oracle")
        lp = XS.launch_plan(aln.VR)
        cases.append(dict(rec, threads=lp.threads, rows_per_thread=lp.rows,
                          strips=lp.strips,
                          recursion_launches=sweeper.launches,
                          recursion_equal_native=same))
    return cases


def long_divergent_family(seed: int = 8):
    """LONG_DIVERGENT_SHORT sequences of the divergent family and two of
    ~LONG_DIVERGENT_LEN residues from one root."""
    L = LONG_DIVERGENT_LEN
    return (divergent_family(LONG_DIVERGENT_SHORT)
            + family(2, seed, root_len=L, lo=L - 200, hi=L + 200,
                     subs=DIVERGENT_SUBS))


def long_divergent_case(dev):
    """The long divergent family in --fast mode with the default gpu-fast
    engine: it must route to the exact engine, sweep grids of several
    strips and give the host engine's FASTA byte for byte; its
    tallest launch is held bitwise against the plain version."""
    import kalign_tpu_torch
    from kalign_tpu_torch.core import io as kio
    seqs = long_divergent_family()
    tallest = {}

    def keep(plans, key, live, kind):
        if key[0] > tallest.get("VR", 0):
            tallest.update(VR=key[0], launch=(plans, key, live), kind=kind)
    with sweep_capture(keep):
        msa, wall = align_on_card(seqs, "fast")
    check_alignment(msa.aligned_rows(), seqs)
    t0 = time.perf_counter()
    host = kalign_tpu_torch.align_msa(seqs, mode="fast", engine="host")
    host_wall = time.perf_counter() - t0
    same = kio.format_alignment(msa, "fasta") == \
        kio.format_alignment(host, "fasta")
    st = msa.engine_stats
    if st["engine"] != "gpu":
        raise AssertionError(f"long divergent family: aligned by "
                             f"{st['engine']}, not the exact engine")
    if not same:
        raise AssertionError("long divergent family: the exact engine's "
                             "FASTA differs from the host engine's")
    if tallest.get("VR", 0) <= 4096:
        raise AssertionError("long divergent family: no sweep launch past "
                             "4,096 rows")
    rec, _ = hold_sweep(*tallest["launch"], "long divergent family's "
                        f"tallest launch ({tallest['kind']})", dev)
    return dict(rec, sequences=len(seqs),
                lengths=[min(map(len, seqs)), max(map(len, seqs))],
                mean_seq_distance=st.get("mean_seq_distance"),
                wall_s=round(wall, 3), host_engine_wall_s=round(host_wall, 3),
                sweep_launches=st.get("sweep_launches"),
                identical_fasta_host_engine=same)


def phase_exact_edge(dev):
    """The exact engine's canary on the card (at engine start), then its
    sweep kernel held bitwise against the plain version: single-window
    edge cases, and launches captured from BB30014's alignment in
    default mode on the card (the consistency pre-pass's residue pairs
    in grids packed to exact.PACK_BUDGET rows; merges of residues x
    residues, profile x
    residues and profile x profile), the first two of each kind and grid
    height."""
    from kalign_tpu_torch import engine as TE
    from kalign_tpu_torch.core import io as kio
    from kalign_tpu_torch.gpu import exact as X
    eng = TE.GpuExactEngine(dev)
    emit({"phase": "canary", **eng.stats["canary"]})
    cases = [hold_sweep(*c[1:], c[0], dev)[0] for c in sweep_edge_plans()]
    captured, counts = [], {}

    def keep(plans, key, live, kind):
        k = (kind, key[0], key[3])
        counts[k] = counts.get(k, 0) + 1
        if counts[k] <= 2:
            captured.append((f"BB30014 {kind}", plans, key, live))
    msa = kio.read_alignment(os.path.join(HERE, "tests", "data",
                                          "BB30014.tfa"))
    msa.quiet = True
    with sweep_capture(keep):
        TE.align_msa(msa, consistency_anchors=5, device=dev)
    for what, plans, key, live in captured:
        cases.append(hold_sweep(plans, key, live, what, dev)[0])
    kinds = {k for k, _, _ in counts}
    seen = {k for k in kinds if k == "pairs"} | set(
        "".join(k[len("merge "):] for k in kinds if k != "pairs"))
    if not {"pairs", "0", "1", "2"} <= seen:
        raise AssertionError(f"exact_sweep: BB30014 gave launches of "
                             f"{sorted(kinds)}: not the pairs and every "
                             "merge mode")
    budget = X.PACK_BUDGET["cuda"]
    if not any(c["VR"] == budget and c["case"] == "BB30014 pairs"
               for c in cases):
        raise AssertionError(f"exact_sweep: no {budget}-row packed grid "
                             "held")
    cases += tall_window_cases(dev)
    cases.append(long_divergent_case(dev))
    emit({"phase": "edge_cases", "kernel": "exact_sweep", "cases": cases,
          "launches_by_kind": {f"{k[0]} VR={k[1]}": v
                               for k, v in counts.items()}})


def phase_divergent(seqs):
    """The divergent path: seqs (mean anchor distance in
    DIVERGENT_DISTANCE) in default mode with the default gpu-fast engine,
    every launch count set to 0 just before and read just after: it must
    route to the exact engine "gpu" and launch bpm and exact_sweep, its
    rows must dealign to the inputs, and its FASTA must be the host
    engine's (the native runtime alone) on the same input, byte for
    byte.  Returns (launches, the largest sweep launch: plans, key,
    live)."""
    import kalign_tpu_torch
    from kalign_tpu_torch.core import io as kio
    largest = {}

    def keep(plans, key, live, kind):
        cells = sweep_cells(plans, live)
        if cells > largest.get("cells", -1):
            largest.update(cells=cells, launch=(plans, key, live),
                           kind=kind)
    reset_counts()
    with sweep_capture(keep):
        msa, wall = align_on_card(seqs, "default")
    launches = read_counts()
    check_alignment(msa.aligned_rows(), seqs)
    st = msa.engine_stats
    t0 = time.perf_counter()
    host = kalign_tpu_torch.align_msa(seqs, mode="default", engine="host")
    host_wall = time.perf_counter() - t0
    same = kio.format_alignment(msa, "fasta") == \
        kio.format_alignment(host, "fasta")
    md = st.get("mean_seq_distance", float(np.mean(msa.seq_distances)))
    # what the route costs: gpu-fast on the same input with it turned off
    reset_counts()
    unrouted, unrouted_wall = align_on_card(seqs, "default",
                                            autoroute=False)
    if unrouted.engine_stats["engine"] != "gpu-fast":
        raise AssertionError("divergent: autoroute=False still routed")
    emit({"phase": "path", "path": "divergent", "mode": "default",
          "sequences": len(seqs),
          "lengths": [min(map(len, seqs)), max(map(len, seqs))],
          "engine": st["engine"], "routed_from": st.get("routed_from"),
          "mean_seq_distance": md, "tree": st["tree"],
          "wall_s": round(wall, 3),
          "phase_s": {k: round(v, 3) for k, v in msa.phase_times.items()},
          "sweep_launches": st.get("sweep_launches"),
          "sweep_grids": st.get("sweep_grids"),
          "sweep_steps": st.get("sweep_steps"),
          "hook_calls": st.get("hook_calls"),
          "exact_split_s": {k: round(v, 3) for k, v in
                            st.get("exact_split_s", {}).items()},
          "host_engine_wall_s": round(host_wall, 3),
          "gpu_fast_wall_s": round(unrouted_wall, 3),
          "gpu_fast_phase_s": {k: round(v, 3) for k, v in
                               unrouted.phase_times.items()},
          "identical_fasta_host_engine": same, "launches": launches,
          "largest_sweep": dict(kind=largest.get("kind"),
                                cells=largest.get("cells"),
                                **(sweep_shape(*largest["launch"])
                                   if largest else {}))})
    if st["engine"] != "gpu":
        raise AssertionError(f"divergent: aligned by {st['engine']}, not "
                             "the exact engine")
    lo, hi = DIVERGENT_DISTANCE
    if not lo <= md <= hi:
        raise AssertionError(f"divergent: mean anchor distance {md} "
                             f"outside [{lo}, {hi}]")
    missing = [k for k in ("bpm", "exact_sweep") if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the divergent "
                             f"path: {missing}")
    if not same:
        raise AssertionError("divergent: the exact engine's FASTA differs "
                             "from the host engine's")
    return launches, largest["launch"]


def precise_family():
    """The precise path's input: PRECISE_N proteins of 270-330 residues."""
    return family(PRECISE_N, seed=PRECISE_SEED)


def phase_precise(dev, seqs):
    """The precise path: seqs through align_msa(mode="precise") on the
    card (its runs share one GpuEngine, passed as ``engine``, whose stats
    then hold every launch batch), every launch count set to 0 just
    before and read just after: each kernel of PRECISE["launch"] must
    have launched, none of PRECISE["forbid"]; every run on gpu-fast (no
    autoroute); rows that dealign to the inputs; confidences in [0, 1],
    one per column.  Prints the wall, the phase split (runs and the
    realign passes among them, POAR extraction and scoring, consensus,
    the post-selection run, confidences), which of selection or
    consensus won, and the launches; then holds the path's largest row
    launch bitwise against the plain version (row_dp_entry).  Returns
    (launches, that launch's entry)."""
    import torch
    import kalign_tpu_torch
    from kalign_tpu_torch.gpu import gotoh_row
    from kalign_tpu_torch.gpu.engine import GpuEngine
    eng = GpuEngine(dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    msa = kalign_tpu_torch.align_msa(seqs, mode="precise", engine=eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    rows = msa.aligned_rows()
    width = check_alignment(rows, seqs)
    ens = msa.engine_stats["ensemble"]
    col = np.asarray(msa.col_confidence, np.float64)
    routes = {}
    for b in eng.stats["batches"]:
        key = f"{'maps' if b['maps'] else 'merges'} {b['route']}"
        routes[key] = routes.get(key, 0) + 1
    emit({"phase": "path", "path": "precise", "mode": "precise",
          "sequences": len(seqs),
          "lengths": [min(map(len, seqs)), max(map(len, seqs))],
          "width": width, "wall_s": round(wall, 3),
          "phase_s": {k: round(v, 3) for k, v in msa.phase_times.items()},
          "winner": ens["winner"], "best_run": ens["best_run"],
          "scores": ens["scores"], "consensus_score":
          ens["consensus_score"], "refined_score": ens["refined_score"],
          "run_engines": ens["run_engines"], "map_pairs":
          eng.stats["map_pairs"], "launch_batch_counts": routes,
          "passes": len(eng.stats["candidate_passes"]),
          "launches": launches})
    missing = [k for k in PRECISE["launch"] if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the precise path: "
                             f"{missing}")
    stray = [k for k in PRECISE["forbid"] if launches[k]]
    if stray:
        raise AssertionError(f"precise: launched {stray}")
    if set(ens["run_engines"]) != {"gpu-fast"}:
        raise AssertionError(f"precise: runs aligned by "
                             f"{ens['run_engines']}, not gpu-fast")
    if col.shape != (width,) or not np.all(np.isfinite(col)) \
            or col.min() < 0.0 or col.max() > 1.0:
        raise AssertionError("precise: column confidences out of [0, 1] "
                             "or of another width")
    largest = max((b for b in eng.stats["batches"] if b["route"] == "row"
                   and gotoh_row.launch_config(
                       len(b["la"]), b["L2p"]).route == "row"),
                  key=batch_cells)
    entry = row_dp_entry("gotoh_row", dp_problem(
        np.random.default_rng(11), largest["L1p"], largest["L2p"],
        largest["la"], largest["lb"], dev), 5)
    emit({"phase": "main_shape", "kernel": "gotoh_row", "path": "precise",
          "maps": bool(largest["maps"]), **entry})
    return launches, entry


def phase_goldens(dev):
    """CARD_GOLDENS through the bit-exact engine "gpu" on the card, every
    launch count set to 0 just before each: the golden file's bytes, the
    sweep kernel launched."""
    from kalign_tpu_torch import engine as E
    from kalign_tpu_torch import ensemble as ens
    from kalign_tpu_torch.core import io as kio
    for golden, (inp, runs, realign) in CARD_GOLDENS.items():
        msa = kio.read_inputs([os.path.join(HERE, "tests", "data", inp)])
        msa.quiet = True
        reset_counts()
        t0 = time.perf_counter()
        if runs:
            out = ens.ensemble_align(msa, n_runs=runs, realign=realign,
                                     consistency_anchors=5, engine="gpu",
                                     device=dev)
        else:
            out = E.align_msa(msa, consistency_anchors=5, realign=realign,
                              engine="gpu", device=dev)
        wall = time.perf_counter() - t0
        launches = read_counts()
        with open(os.path.join(HERE, "tests", "golden", golden)) as fh:
            same = kio.write_fasta(out) == fh.read()
        emit({"phase": "golden", "golden": golden, "engine": "gpu",
              "ensemble": runs, "realign": realign, "wall_s": round(wall, 3),
              "golden_fasta": same, "launches": launches})
        if not same:
            raise AssertionError(f"{golden}: engine gpu on the card did not "
                                 "give the golden bytes")
        if launches["exact_sweep"] == 0:
            raise AssertionError(f"{golden}: the sweep kernel did not launch")


# ---------------------------------------------------------------------------
# the serve path: a warm server in this process answering a request stream
SERVE_LAUNCH = ["bpm", "bpm_table", "gotoh_lanewise", "gotoh_fused",
                "gotoh_row", "traceback", "prefix_sum", "exact_sweep",
                "prepare_match"]
SERVE_FORBID = ["gotoh_row_wave"]
# seconds the in-process server, and the server a --server-start spawns,
# may take to answer
SERVE_READY_TIMEOUT_S = 300


def serve_requests():
    """The request stream: (name, argv, golden file or None, the engines
    its alignments must resolve to or None).  Relative paths, in the
    client's working directory; -q keeps the server's stderr quiet."""
    BB11001 = ["-i", "BB11001.tfa", "-o", "r1.afa", "-q"]
    prot = ["-i", "prot2000.fa", "-q"]
    return [
        ("BB11001", BB11001, None, ["gpu-fast"]),
        ("BB12006-fast", ["-i", "BB12006.tfa", "-o", "r2.afa", "--fast",
                          "-q"], None, ["gpu-fast"]),
        ("BB30014", ["-i", "BB30014.tfa", "-o", "r3.afa", "-q"],
         "BB30014.default.afa", ["gpu"]),
        ("small-precise-sto", ["-i", "small.fa", "-o", "r4.sto",
                               "--precise", "-f", "sto", "-q"], None, None),
        ("protein2000", prot + ["-o", "r5.afa"], None, ["gpu-fast"]),
        ("dna2000", ["-i", "dna2000.fa", "-o", "r6.afa", "-q"], None,
         ["gpu-fast"]),
        ("tiny-auto", ["-i", "tiny.fa", "-o", "r7.afa", "--engine", "auto",
                       "-q"], "tiny.default.afa", ["host"]),
        ("protein2000-auto", prot + ["-o", "r8.afa", "--engine", "auto"],
         None, ["gpu-fast"]),
        ("missing-input", ["-i", "missing.fa", "-o", "r9.afa", "-q"], None,
         None),
        ("BB11001-warm1", BB11001, None, ["gpu-fast"]),
        ("BB11001-warm2", BB11001, None, ["gpu-fast"]),
        ("BB11001-warm3", BB11001, None, ["gpu-fast"]),
        ("protein2000-trace", prot + ["-o", "r11.afa", "--trace",
                                      "trace11"], None, ["gpu-fast"]),
        ("protein2000-trace2", prot + ["-o", "r12.afa", "--trace",
                                       "trace12"], None, ["gpu-fast"]),
    ]


def serve_workdir():
    """A scratch directory for the stream's files and sockets, with the
    inputs: the BAliBASE families, small.fa and tiny.fa, and the two
    full-width families as FASTA (family(2000, seed=0), the
    protein_default path's input; v4_family(2000, seed=2), the default
    path's).  A unix socket's path must stay under 108 bytes."""
    import shutil
    import tempfile
    work = tempfile.mkdtemp(prefix="kts")
    if len(work) > 80:
        shutil.rmtree(work)
        work = tempfile.mkdtemp(prefix="kts", dir="/tmp")
    for f in ("BB11001.tfa", "BB12006.tfa", "BB30014.tfa", "small.fa",
              "tiny.fa"):
        shutil.copy(os.path.join(HERE, "tests", "data", f), work)
    for name, seqs in (("prot2000.fa", family(2000, seed=0)),
                       ("dna2000.fa", v4_family(2000, seed=2))):
        with open(os.path.join(work, name), "w") as fh:
            fh.write("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
    return work


@contextmanager
def watched_align_msa(seen):
    """engine.align_msa wrapped so that each alignment appends (the
    engine that aligned, whether it ran off the main thread, its current
    CUDA device and stream) to seen."""
    import threading
    from kalign_tpu_torch import engine as E
    from kalign_tpu_torch.gpu import _cuda
    import torch
    orig = E.align_msa

    def wrapped(*a, **k):
        out = orig(*a, **k)
        seen.append((out.engine_stats.get("engine"),
                     threading.current_thread() is not threading.main_thread(),
                     torch.cuda.current_device(), _cuda.stream("cuda")))
        return out
    E.align_msa = wrapped
    try:
        yield
    finally:
        E.align_msa = orig


def trace_summary(trace_dir, launched):
    """What the --trace request's trace holds: each process's name and
    labels, the processes of its kernel records, and per kernel of the
    request the records of its name (PROFILE_NAMES)."""
    import glob
    names, procs, kernel_pids, by_cat = {}, {}, set(), {}
    for path in glob.glob(os.path.join(trace_dir, "*.pt.trace.json")):
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
        for e in events:
            if e.get("ph") == "M" and e.get("name") in ("process_name",
                                                        "process_labels"):
                arg = "labels" if e["name"] == "process_labels" else "name"
                procs.setdefault(str(e.get("pid")), []).append(
                    (e.get("args") or {}).get(arg))
            elif e.get("ph") == "X" and e.get("cat") == "kernel":
                names[e["name"]] = names.get(e["name"], 0) + 1
                kernel_pids.add(str(e.get("pid")))
            if e.get("ph") == "X" and str(e.get("pid")) in kernel_pids:
                cat = str(e.get("cat"))
                by_cat[cat] = by_cat.get(cat, 0.0) + e.get("dur", 0) / 1e3
    records = {k: sum(c for n, c in names.items() if PROFILE_NAMES[k] in n)
               for k, v in launched.items() if v}
    return procs, sorted(kernel_pids), records, by_cat


def served_stream(work, sock, problems):
    """The stream through serve.serve in a thread of this process (launch
    counts set to 0 once the warmup is done, read after the last
    request).  Returns (warmup launches, the stream's launches, the
    in-process ready seconds, per-request records, served output
    bytes)."""
    import threading
    import torch
    from kalign_tpu_torch import serve
    from kalign_tpu_torch.gpu import _cuda
    box, ready = {}, threading.Event()

    def on_ready():
        box["warmup"] = read_counts()
        box["ready_s"] = time.perf_counter() - t0
        reset_counts()
        ready.set()

    def run():
        try:
            serve.serve(sock, warmup=True, ready_cb=on_ready)
        except BaseException as e:  # raised again in the main thread
            box["error"] = e
            ready.set()

    main_stream = (torch.cuda.current_device(), _cuda.stream("cuda"))
    reset_counts()
    t0 = time.perf_counter()
    th = threading.Thread(target=run, name="kalign-serve", daemon=True)
    th.start()
    if not ready.wait(SERVE_READY_TIMEOUT_S):
        raise AssertionError("the in-process server did not come up")
    if "error" in box:
        raise box["error"]
    records, outputs, seen = [], {}, []
    try:
        with watched_align_msa(seen):
            for name, argv, golden, engines in serve_requests():
                seen.clear()
                before = read_counts()
                resp = serve.request(sock, argv)
                after = read_counts()
                rec = dict(name=name, argv=argv, **resp,
                           engines=[s[0] for s in seen],
                           launches={k: after[k] - before[k]
                                     for k in after if after[k] > before[k]})
                if any(not s[1] or (s[2], s[3]) != main_stream
                       for s in seen):
                    problems.append(f"{name}: aligned off a handler thread "
                                    f"or on another device or stream: "
                                    f"{seen} (main: {main_stream})")
                if name == "missing-input":
                    if resp["rc"] == 0 or not resp["error"]:
                        problems.append(f"{name}: answered {resp}")
                elif resp["rc"] != 0 or resp["error"]:
                    problems.append(f"{name}: answered {resp}")
                else:
                    out = argv[argv.index("-o") + 1]
                    with open(os.path.join(work, out), "rb") as fh:
                        outputs[name] = fh.read()
                if engines is not None and rec["engines"] != engines:
                    problems.append(f"{name}: aligned by {rec['engines']}, "
                                    f"not {engines}")
                records.append(rec)
        launches = read_counts()
    finally:
        serve.shutdown(sock)
        th.join(60)
    if th.is_alive():
        raise AssertionError("the in-process server did not stop")
    return box["warmup"], launches, box["ready_s"], records, outputs


def cold_start(work, problems):
    """The cold start as users pay it, in fresh processes (the libraries
    already built): one one-shot CLI call on BB11001 (cold_cli_s); then
    one CLI call with --server=SOCK --server-start, which spawns the
    server: ready_s from its start until the socket answers, first_s
    from then until the call exits (the call polls the socket every
    0.1 s); then one more --server call to that server (client_s: what
    each call of a warm deployment pays, the client's own start-up
    included); then shutdown, and the spawned server must exit; last,
    import_s, a process that only imports the aligner (kalign_tpu_torch.api,
    torch among its imports).  Returns
    ({those seconds}, {output file: bytes})."""
    import socket
    from kalign_tpu_torch import serve
    env = dict(os.environ, PYTHONPATH=HERE)
    cli = [sys.executable, "-m", "kalign_tpu_torch.cli", "-i", "BB11001.tfa",
           "-q"]
    t0 = time.perf_counter()
    res = subprocess.run(cli + ["-o", "cold.afa"], cwd=work, env=env,
                         capture_output=True, text=True,
                         timeout=SERVE_READY_TIMEOUT_S)
    cold_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"the one-shot CLI failed: {res.stderr[-2000:]}")
    sock = os.path.join(work, "spawned.sock")

    def answers():
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            try:
                s.connect(sock)
                return True
            except OSError:
                return False

    def server_pids():
        pids = []
        for p in os.listdir("/proc"):
            try:
                with open(f"/proc/{p}/cmdline", "rb") as fh:
                    cmd = fh.read().split(b"\0")
            except OSError:
                continue
            if b"kalign_tpu_torch.serve" in cmd and sock.encode() in cmd:
                pids.append(int(p))
        return pids

    def running(pid):
        try:
            with open(f"/proc/{pid}/stat") as fh:
                return fh.read().rsplit(")", 1)[1].split()[0] != "Z"
        except OSError:
            return False

    t_start = time.perf_counter()
    proc = subprocess.Popen(cli + ["-o", "first.afa", f"--server={sock}",
                                   "--server-start"], cwd=work, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    pids = []
    try:
        while not answers():
            if time.perf_counter() - t_start > SERVE_READY_TIMEOUT_S \
                    or proc.poll() is not None:
                raise AssertionError("the spawned server did not answer: "
                                     f"{proc.poll()}")
            time.sleep(0.01)
        t_ready = time.perf_counter()
        pids = server_pids()
        _, err = proc.communicate(timeout=SERVE_READY_TIMEOUT_S)
        t_done = time.perf_counter()
        if proc.returncode != 0:
            raise AssertionError(f"the --server-start call failed: "
                                 f"{err[-2000:]}")
        if len(pids) != 1:
            raise AssertionError(f"spawned servers found: {pids}")
        t0 = time.perf_counter()
        res = subprocess.run(cli + ["-o", "client.afa", f"--server={sock}"],
                             cwd=work, env=env, capture_output=True,
                             text=True, timeout=SERVE_READY_TIMEOUT_S)
        client_s = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"a --server call failed: "
                                 f"{res.stderr[-2000:]}")
        serve.shutdown(sock)
        t_stop = time.perf_counter()
        while running(pids[0]) and time.perf_counter() - t_stop < 60:
            time.sleep(0.05)
        if running(pids[0]):
            problems.append("the spawned server did not exit after "
                            "shutdown")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for pid in pids:
            if running(pid):
                os.kill(pid, 9)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", "import kalign_tpu_torch.api"],
                   cwd=work, env=env, check=True,
                   timeout=SERVE_READY_TIMEOUT_S)
    import_s = time.perf_counter() - t0
    outs = {}
    for f in ("cold.afa", "first.afa", "client.afa"):
        with open(os.path.join(work, f), "rb") as fh:
            outs[f] = fh.read()
    return dict(cold_cli_s=cold_s, ready_s=t_ready - t_start,
                first_s=t_done - t_ready, client_s=client_s,
                import_s=import_s), outs


def phase_serve(dev):
    """The serve path: a warm server (serve.serve, warmup on) in a thread
    of this process answers serve_requests() sent through serve.request
    from a scratch directory with relative paths; every launch count is
    set to 0 once the warmup is done and read after the last request.
    Every output must equal the same argv run one-shot through
    cli.main in this process, BB30014 and tiny.fa also their golden
    files; "auto" must resolve to host on tiny.fa and to gpu-fast on the
    2,000-protein family (whose bytes it must give); the missing input
    must get rc != 0 with its error, and the server must answer on; the
    stream must launch SERVE_LAUNCH and no SERVE_FORBID; the --trace
    request's trace must name its kernels, its device seconds in
    (0, wall].  Then the cold start (cold_start).  Prints the path line;
    returns the stream's launches."""
    import shutil
    from kalign_tpu_torch import cli
    from kalign_tpu_torch.utils import devtime
    problems = []
    work = serve_workdir()
    cwd = os.getcwd()
    try:
        os.chdir(work)
        warm, launches, inproc_ready_s, records, served = served_stream(
            work, os.path.join(work, "inproc.sock"), problems)
        by_name = {r["name"]: r for r in records}
        trace_dir = os.path.join(work, "trace11")
        procs, kernel_pids, records_in_trace, by_cat = trace_summary(
            trace_dir, by_name["protein2000-trace"]["launches"])
        device_s = devtime.device_seconds(trace_dir)
        trace = dict(processes=procs, kernel_pids=kernel_pids,
                     device_ms_by_category=by_cat, device_s=device_s,
                     second_device_s=devtime.device_seconds(
                         os.path.join(work, "trace12")),
                     kernel_records=records_in_trace,
                     launches=by_name["protein2000-trace"]["launches"])
        if not 0.0 < device_s <= by_name["protein2000-trace"]["wall_s"]:
            problems.append(f"trace: device_seconds {device_s} outside "
                            "(0, wall]")
        lost = {k: (c, trace["launches"][k])
                for k, c in records_in_trace.items() if c == 0}
        if lost:
            problems.append(f"trace: no record of {lost}")
        # the same argv one-shot, in this process, from the same directory
        oneshot = {}
        for name, argv, golden, _ in serve_requests():
            if name == "missing-input":
                try:
                    cli.main(argv)
                    problems.append("missing-input: the one-shot run "
                                    "did not fail")
                except (OSError, SystemExit):
                    pass
                continue
            if name not in served:
                continue
            key = " ".join(argv)
            if key not in oneshot:
                t0 = time.perf_counter()
                if cli.main(argv) != 0:
                    problems.append(f"{name}: the one-shot run failed")
                with open(argv[argv.index("-o") + 1], "rb") as fh:
                    oneshot[key] = (fh.read(), time.perf_counter() - t0)
            same = served[name] == oneshot[key][0]
            by_name[name]["same_as_oneshot"] = same
            by_name[name]["oneshot_s"] = round(oneshot[key][1], 3)
            if not same:
                problems.append(f"{name}: served bytes differ from the "
                                "one-shot run's")
            if golden is not None:
                with open(os.path.join(HERE, "tests", "golden", golden),
                          "rb") as fh:
                    by_name[name]["golden"] = served[name] == fh.read()
                if not by_name[name]["golden"]:
                    problems.append(f"{name}: not {golden}")
        if served.get("protein2000-auto") != served.get("protein2000"):
            problems.append("protein2000-auto: not protein2000's bytes")
        cold, cold_outs = cold_start(work, problems)
        for f, b in cold_outs.items():
            if b != served["BB11001"]:
                problems.append(f"cold start: {f} differs from the served "
                                "BB11001 bytes")
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    warm_walls = [by_name[f"BB11001-warm{i}"]["wall_s"] for i in (1, 2, 3)]
    emit({"phase": "path", "path": "serve", **cold,
          "inprocess_ready_s": inproc_ready_s,
          "warm_bb11001_median_s": float(np.median(warm_walls)),
          "requests": records, "trace": trace,
          "launches": launches, "warmup_launches": warm})
    missing = [k for k in SERVE_LAUNCH if launches[k] == 0]
    if missing:
        problems.append(f"kernels not launched on the serve path: {missing}")
    stray = [k for k in SERVE_FORBID if launches[k]]
    if stray:
        problems.append(f"serve: launched {stray}")
    if problems:
        raise AssertionError("serve: " + "; ".join(problems))
    return launches


class _Stop(Exception):
    """Ends a run once a capture has what it needs."""


def divergent_prepass_pairs(n: int = DIVERGENT_N):
    """The first slice of the divergent path's consistency pre-pass, as
    the native runtime hands it to the exact engine (its alignment with
    engine "gpu" on the card, stopped at the first pairwise hook call):
    (pairs of residue codes, subm, gpo, gpe, tgpe)."""
    import kalign_tpu_torch
    from kalign_tpu_torch.gpu import exact as X
    got = []
    init = X.ExactPairBatch.__init__

    def rec(self, pairs, subm, gpo, gpe, tgpe, sweeper=None):
        got.append(([(np.array(a), np.array(b)) for a, b in pairs],
                    np.array(subm), gpo, gpe, tgpe))
        raise _Stop()
    X.ExactPairBatch.__init__ = rec
    try:
        kalign_tpu_torch.align_msa(divergent_family(n), mode="default",
                                   engine="gpu")
    except RuntimeError:
        pass
    finally:
        X.ExactPairBatch.__init__ = init
    if not got:
        raise AssertionError("divergent: no pre-pass pairs reached the "
                             "exact engine")
    return got[0]


def prepass_plan(prepass, dev, grids=64, budget=4096):
    """The top depth of the pre-pass pairs (divergent_prepass_pairs)
    packed to ``budget`` rows in one launch, cut to its first ``grids``
    grids (64 x 4,096: the divergent path's largest sweep launch before
    grids were packed short): (plans, key, live)."""
    from kalign_tpu_torch.gpu import exact as X
    pairs, subm, gpo, gpe, tgpe = prepass
    saved = X.PACK_BUDGET["cuda"], X.LAUNCH_CELLS
    X.PACK_BUDGET["cuda"], X.LAUNCH_CELLS = budget, 1 << 62
    got = []

    def keep(plans, key, live, kind):
        got.append((plans, key, live))
        raise _Stop()
    try:
        with sweep_capture(keep):
            X.ExactPairBatch(pairs, subm, gpo, gpe, tgpe,
                             X.Sweeper(dev)).run(
                [np.full(len(a) + 2, -1, np.int32) for a, _ in pairs])
    except _Stop:
        pass
    finally:
        X.PACK_BUDGET["cuda"], X.LAUNCH_CELLS = saved
    (plans, key, live), = got
    cut = {k: v[:grids] for k, v in plans.items()}
    nslot = int(np.max(np.where(cut["is_final"], cut["win_slot"], -1))) + 1
    return cut, key, (nslot, live[1])


def sweep_main_shape(dev, launch):
    """The sweep kernel at the divergent path's largest launch: held
    bitwise against its plain version (hold_sweep) and timed beside it
    (on the card) and its bound (8 bytes of match and bonus per processed
    cell, the rows' and columns' addends, the output; SWEEP_OPS_PER_CELL fp32
    operations per cell, SWEEP_CHAIN_OPS more in chain form), with its
    block (threads, rows per thread, strips), its blocks and the steps of
    its longest block (the band-local schedule) beside the reference
    schedule's."""
    from kalign_tpu_torch.gpu import exact_sweep as XS
    plans, key, live = launch
    VR, C, Wmax, chain = key
    rec, t = hold_sweep(plans, key, live, "the divergent path's largest "
                        "launch", dev)
    run = lambda: XS.launch(t, VR, C, Wmax, chain, *live)
    _, plain_ms = timed_once(lambda: XS.plain(
        t, VR, C, Wmax, chain, XS.live_steps(VR, C, live[1])))
    G = rec["grids"]
    cells = rec["cells"]
    bytes_ = (cells * 8 + G * VR * (16 + 32) + G * (C + 1) * 16
              + G * live[0] * live[1] * 12)
    ops = cells * (SWEEP_OPS_PER_CELL + (SWEEP_CHAIN_OPS if chain else 0))
    b_ms, b_by = bound(bytes_, ops, FP32_OPS_PER_S)
    lp = XS.launch_plan(VR)
    _, span = XS.schedule(plans, live[1], lp.threads * lp.rows)
    return dict(shape=f"{G} x {VR} x {C + 1}", ms=cuda_time_ms(run, reps=3),
                device_ms=device_ms(run, 3), plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None, cells=cells,
                steps=XS.steps_run(span),
                reference_steps=XS.live_steps(VR, C, live[1]),
                chain=bool(chain), blocks=G, threads=lp.threads,
                rows_per_thread=lp.rows, strips=lp.strips)


def counters():
    """{kernel: (wrapper module, name of its launch count)}"""
    from kalign_tpu_torch.gpu import bpm, exact_sweep, gotoh_fused, \
        gotoh_lanewise, gotoh_mesh, gotoh_row, gotoh_wave, kmeans, prepare, \
        scan
    from kalign_tpu_torch.gpu import traceback as tb
    mods = {"gotoh_row": gotoh_row, "gotoh_lanewise": gotoh_lanewise,
            "bpm": bpm, "traceback": tb, "prefix_sum": scan,
            "gotoh_fused": gotoh_fused, "kmeans": kmeans,
            "exact_sweep": exact_sweep, "gotoh_mesh": gotoh_mesh,
            "gotoh_row_wave": gotoh_wave, "prepare_match": prepare}
    out = {k: (m, "launches") for k, m in mods.items()}
    out["bpm_table"] = (bpm, "table_launches")
    out["gotoh_row_cluster"] = (gotoh_row, "cluster_launches")
    out["gotoh_mesh_cluster"] = (gotoh_mesh, "cluster_launches")
    return out


def reset_counts():
    for m, attr in counters().values():
        setattr(m, attr, 0)


def read_counts():
    return {k: getattr(m, attr) for k, (m, attr) in counters().items()}


def check_alignment(rows, seqs):
    if len(rows) != len(seqs):
        raise AssertionError("row count differs from the input")
    widths = {len(r) for r in rows}
    if len(widths) != 1:
        raise AssertionError(f"rows of unequal width: {sorted(widths)[:5]}")
    for i, (r, s) in enumerate(zip(rows, seqs)):
        if r.replace("-", "") != s:
            raise AssertionError(f"row {i} de-gapped differs from its input")
    return widths.pop()


def align_on_card(seqs, mode, engine="gpu-fast", refine=None,
                  autoroute=True):
    """(Msa, wall seconds) of one alignment on the card."""
    import torch
    import kalign_tpu_torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    msa = kalign_tpu_torch.align_msa(seqs, mode=mode, engine=engine,
                                     refine=refine, autoroute=autoroute)
    torch.cuda.synchronize()
    return msa, time.perf_counter() - t0


def pass_summary(msa, wall):
    """Wall, phase split and the progressive pass's host split and
    transfers of one alignment."""
    st = msa.engine_stats
    return {"wall_s": round(wall, 3),
            "phase_s": {k: round(v, 3) for k, v in msa.phase_times.items()},
            "progressive_split_s": {k: round(v, 4) for k, v in
                                    st["progressive_split_s"].items()},
            "fetches": st["fetches"], "levels": len(st["levels"])}


def refine_divergence(res, host):
    """Where the resident and host-assembled passes of a refined alignment
    part ways (their FASTA differ): the first merge, pass by pass and in
    task order (a merge's task index is above its children's), whose
    chosen candidate or candidate set differs. The resident pass scores
    the candidates' SP in float32 on the card, the host pass in float64,
    so a near-SP-tie may go either way: the divergence must be one, its
    candidates' SP equal to rel 1e-5 in the host's scores (for a candidate
    set that differs, in the probe pass that flagged it). Returns a
    record, or raises."""
    passes = list(zip(res.engine_stats["candidate_passes"],
                      host.engine_stats["candidate_passes"]))
    for p, (cr, ch) in enumerate(passes):
        for t in sorted(set(cr) | set(ch)):
            a, b = cr.get(t), ch.get(t)
            if a is not None and b is not None and a[0] == b[0]:
                continue
            if a is None or b is None:
                # the probe's paths disagreed in one pass only: its
                # candidates must tie in SP there
                sps = passes[0][1].get(t, (0, []))[1]
                ok = bool(sps) and max(sps) - min(sps) <= \
                    1e-5 * abs(max(sps))
                what = "candidate set"
            else:
                sps = b[1]
                ok = abs(sps[a[0]] - sps[b[0]]) <= 1e-5 * abs(sps[b[0]])
                what = "choice"
            rec = dict(pass_index=p, task=int(t), differs_in=what,
                       resident=a, host=b)
            if not ok:
                raise AssertionError(f"refined passes diverge at a merge "
                                     f"whose candidates do not tie: {rec}")
            return rec
    a = np.asarray(res.task_confidence, np.float64)
    b = np.asarray(host.task_confidence, np.float64)
    bad = np.flatnonzero(np.abs(a - b) > 1e-5 * np.abs(b))
    if len(bad):
        raise AssertionError(f"refined passes chose the same candidates but "
                             f"merge {int(bad[0])} scores {a[bad[0]]} vs "
                             f"{b[bad[0]]}")
    return dict(differs_in="paths of equal score")


def phase_path(path: str, seqs):
    """One alignment of seqs on the path's mode on the card, every launch
    count set to 0 just before it and read just after; then, unless the
    path skips it, the same alignment with the host-assembled progressive
    pass, which must give the same FASTA (a refined path: or a divergence
    at a near-SP-tie, refine_divergence)."""
    from kalign_tpu_torch.core import io as kio
    from kalign_tpu_torch.gpu.engine import GpuEngine
    cfg = PATHS[path]
    mode, must_launch, refine = cfg["mode"], cfg["launch"], cfg.get("refine")
    reset_counts()
    msa, wall = align_on_card(seqs, mode, refine=refine)
    launches = read_counts()
    rows = msa.aligned_rows()
    width = check_alignment(rows, seqs)
    FASTA[path] = kio.format_alignment(msa, "fasta")
    stats = msa.engine_stats
    line = {"phase": "path", "path": path, "mode": mode, "refine": refine,
            "sequences": len(seqs),
            "lengths": [min(map(len, seqs)), max(map(len, seqs))],
            "width": width, "tree": stats["tree"],
            "tree_s": stats.get("tree_s"),
            "shards": stats.get("shards", 1), "cards": stats.get("cards", 1),
            **pass_summary(msa, wall)}
    same, divergence = True, None
    if cfg.get("host_pass", True):
        host, host_wall = align_on_card(seqs, mode,
                                        GpuEngine("cuda", resident=False),
                                        refine=refine)
        same = kio.format_alignment(msa, "fasta") == \
            kio.format_alignment(host, "fasta")
        line["host_pass"] = pass_summary(host, host_wall)
        line["identical_fasta_host_pass"] = same
        if refine and not same:
            divergence = refine_divergence(msa, host)
            line["divergence"] = divergence
    if refine:
        line["refine_flagged"] = stats.get("refine_flagged")
        line["refined_merges"] = len(stats["candidates"])
    routes = {}
    for b in stats["batches"]:
        key = f"{'maps' if b['maps'] else 'merges'} {b['route']}"
        routes.setdefault(key, []).append(
            f"{len(b['la'])}x{b['L1p']}x{b['L2p']}")
    emit({**line,
          "mean_seq_distance": float(np.mean(msa.seq_distances)),
          "map_pairs": stats["map_pairs"],
          "row_merges": stats["row_merges"],
          "lanewise_merges": stats["lanewise_merges"],
          "fused_merges": stats["fused_merges"],
          "launches": launches,
          "launch_batches": {k: v[:40] for k, v in routes.items()},
          "launch_batch_counts": {k: len(v) for k, v in routes.items()},
          "buckets_by_level": stats["levels"][:80]})
    missing = [k for k in must_launch if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: "
                             f"{missing}; buckets per level: "
                             f"{stats['levels']}")
    stray = [k for k in cfg.get("forbid", ()) if launches[k]]
    if stray:
        raise AssertionError(f"{path}: launched {stray}")
    if not (stats["engine"] == "gpu-fast"
            and np.mean(msa.seq_distances) < AUTOROUTE_DISTANCE):
        raise AssertionError(f"{path}: mean anchor distance "
                             f"{np.mean(msa.seq_distances)} routed it to "
                             f"{stats['engine']}")
    passes = len(stats["candidate_passes"])
    if stats["fetches"] != len(stats["levels"]) + passes:
        raise AssertionError(f"{path}: the resident pass fetched "
                             f"{stats['fetches']} times over "
                             f"{len(stats['levels'])} levels in {passes} "
                             "passes")
    if "kmeans" in must_launch and stats["tree"] != "device_fused":
        raise AssertionError(f"{path}: the {stats['tree']} tree ran, not "
                             "the fused device tree")
    if not same and divergence is None:
        raise AssertionError(f"{path}: the resident and host-assembled "
                             "passes gave different alignments")
    return launches, stats


def phase_profile(path: str, seqs, launches):
    """A path once more under torch.profiler: device time by kernel, the
    device time under each part of the progressive pass (its
    ``progressive.<part>`` ranges), and the device's busy share of the
    run's wall time.  The trace must hold each kernel as many times as the
    path launched it: a trace that lost records is taken again, twice at
    most."""
    from torch.autograd import DeviceType
    import kalign_tpu_torch
    mode = PATHS[path]["mode"] if path in PATHS else \
        PRECISE["mode"] if path == "precise" else "default"
    # the exact engine's path has no progressive.<part> ranges: its trace
    # keeps the card's activity only (its CPU side's ~100 operations a
    # sweep launch made that trace's processing take minutes)
    cpu = path in PATHS
    for attempt in range(3):
        prof, _, wall_s = profiled(
            lambda: kalign_tpu_torch.align_msa(seqs, mode=mode), cpu)
        # one pass over the trace's events: at 16,384 sequences each
        # key_averages() takes seconds
        averages = prof.key_averages()
        counts = {name: sum(e.count for e in averages
                            if e.device_type == DeviceType.CUDA
                            and sub in e.key)
                  for name, sub in PROFILE_NAMES.items()}
        lost = {k: (c, launches[k]) for k, c in counts.items()
                if c != launches[k]}
        if not lost:
            break
        emit({"phase": "profile", "path": path, "attempt": attempt,
              "lost_records": lost})
    else:
        raise AssertionError(f"the {path} path's trace lacks launches "
                             f"(traced, launched): {lost}")
    wall_us = wall_s * 1e6

    # device-side entries only (kernels and copies): an operator's
    # device time is also listed under the kernels it launched, and a
    # progressive.<part> range's device-side span under the range
    rows = sorted(((e.key, dev_us(e), e.count)
                   for e in averages
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0
                   and not e.key.startswith("progressive.")),
                  key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    if busy_us <= 0:
        raise AssertionError("the profiler saw no device time")
    totals = {}
    for name, sub in PROFILE_NAMES.items():
        hit = [(us, c) for k, us, c in rows if sub in k]
        totals[name] = {"device_ms": round(sum(h[0] for h in hit) / 1e3, 3),
                        "launches": sum(h[1] for h in hit)}
    # each progressive.<part> range: the device time of the kernels its
    # operations launched (host-side entry) and the span from its first
    # kernel's start to its last one's end (device-side entry)
    parts, spans = {}, {}
    for e in averages:
        if e.key.startswith("progressive."):
            part = e.key.split(".", 1)[1]
            if e.device_type == DeviceType.CUDA:
                spans[part] = round(dev_us(e) / 1e3, 3)
            else:
                parts[part] = round(getattr(e, "device_time_total", getattr(
                    e, "cuda_time_total", 0.0)) / 1e3, 3)
    emit({"phase": "profile", "path": path,
          "wall_s": round(wall_us / 1e6, 3),
          "device_busy_s": round(busy_us / 1e6, 4),
          "device_idle_share": round(1.0 - busy_us / wall_us, 4),
          "progressive_device_ms": parts,
          "progressive_device_span_ms": spans,
          "kernels": totals,
          "top": [{"name": k[:80], "device_ms": round(us / 1e3, 3),
                   "calls": c} for k, us, c in rows[:12]]})


def bound(bytes_, ops, ops_per_s):
    """(bound ms, what bounds it) of a function moving bytes_ and doing
    ops operations at ops_per_s."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def gotoh_bound(p, dec_bytes_per_cell, nc=0):
    """The cells this run's problems need (la x lb each): a match read (or,
    with nc operands per row and column, those read once instead) and a
    decision write per cell, the penalties of their rows and columns, and
    GOTOH_OPS_PER_CELL fp32 operations per cell, 2 * nc - 1 more to
    compute the match."""
    la = p["la"].cpu().numpy().astype(np.int64)
    lb = p["lb"].cpu().numpy().astype(np.int64)
    cells = float(np.sum(la * lb))
    match_bytes = 0 if nc else 4
    bytes_ = (cells * (match_bytes + dec_bytes_per_cell)
              + float(np.sum(la + lb)) * (12 + 4 * nc) + len(la) * 8)
    ops = GOTOH_OPS_PER_CELL + (2 * nc - 1 if nc else 0)
    return bound(bytes_, cells * ops, FP32_OPS_PER_S)


def memory_latencies_ms(dev):
    """Latencies in ms on this card, from scripts/latency_probe.cu: of one
    dependent shared-memory read, and of one round trip to L2 and to
    device memory.  Each is a pointer chase through a random cycle, of
    8,192 entries in shared memory, of 2^21 (8 MB, written just before,
    so in L2) and of 2^26 (256 MB, L2 flushed first) in device memory,
    timed at H and 2H hops (CUDA events, the least of three launches, the
    chains from starts far apart on the cycle): the difference over H."""
    import ctypes
    import torch
    from kalign_tpu_torch.gpu import _cuda
    lib = ctypes.CDLL(_cuda.library_path("libkt_probe", [PROBE_SRC], []))
    lib.kt_probe_chase.restype = ctypes.c_int
    lib.kt_probe_chase.argtypes = ([ctypes.c_int, ctypes.c_void_p]
                                   + [ctypes.c_int] * 3
                                   + [ctypes.c_void_p] * 2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    sink = torch.empty(1, dtype=torch.int32, device=dev)
    out = {}
    for key, shared, n, hops in (("shared_read", 1, 8192, 100_000),
                                 ("l2_round_trip", 0, 1 << 21, 20_000),
                                 ("device_round_trip", 0, 1 << 26, 20_000)):
        perm = torch.randperm(n, device=dev, generator=gen)
        nxt = torch.empty(n, dtype=torch.int32, device=dev)
        nxt[perm] = perm.roll(-1).to(torch.int32)
        if key == "device_round_trip":
            torch.ones(1 << 26, device=dev).sum()  # evicts nxt from L2
        starts = iter(perm[::n // 8].tolist())
        best = {}
        for h in (hops, 2 * hops):
            for _ in range(3):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                _cuda.check(lib.kt_probe_chase(
                    shared, nxt.data_ptr(), n, next(starts), h,
                    sink.data_ptr(), _cuda.stream(dev)), "latency probe")
                t1.record()
                torch.cuda.synchronize()
                best[h] = min(best.get(h, 1e9), t0.elapsed_time(t1))
        out[key] = (best[2 * hops] - best[hops]) / hops
    return out


def walk_chain_floor(walk_args, lanewise, lat):
    """The walks' chain floor: for each walk its steps at one shared-memory
    read each plus the windows the kernel staged for it at one L2 round
    trip each (the least a window's load can wait: the forward kernel has
    just written the decisions), latencies from memory_latencies_ms; the
    floor is the largest over the walks.  Also that walk's floor with its
    windows from device memory."""
    from kalign_tpu_torch.gpu import traceback as tb
    dec = walk_args[0]
    L1p, L2p = ((dec.shape[2], dec.shape[1] * tb.PACK) if lanewise
                else dec.shape[1:])
    _, n, win = tb.launch(lanewise, *walk_args, L1p, L2p,
                          count_windows=True)
    n, win = n.double(), win.double()
    floor = n * lat["shared_read"] + win * lat["l2_round_trip"]
    b = int(floor.argmax())
    return dict(chain_floor_ms=float(floor[b]), steps=int(n[b]),
                windows=int(win[b]),
                from_device_memory_ms=float(n[b] * lat["shared_read"] + win[b]
                                            * lat["device_round_trip"]))


def hold_dp(name, mod, lanewise, p, reps, entry=None):
    """Kernel vs plain DP on the same prepared inputs: bitwise, then the
    kernel timed over reps launches (events, then device_ms over 5)
    and the plain version once (the lanewise kernel's on the CPU, in a
    host worker: later, which sets entry["plain_ms"]).  Returns (outputs,
    ms, device ms, plain ms or None)."""
    prep = mod.prepare(p["pc"], p["pr"], p["la"], p["lb"], p["slope"],
                       p["eps"])
    args = (p["match"], prep, p["la"], p["lb"])
    out = mod.launch(*args)
    if lanewise:
        plain_ms = None
        hold_dp_later(name, True, out, mod.plain, args, p, shape_of(p),
                      lambda ms: entry.__setitem__("plain_ms", ms))
    else:
        ref, plain_ms = timed_once(lambda: mod.plain(*args))
        hold_dp_outputs(name, lanewise, out, ref, p, shape_of(p))
    run = lambda: mod.launch(*args)
    return out, cuda_time_ms(run, reps=reps), device_ms(run, 5), plain_ms


def shape_of(p):
    return f"{len(p['la'])}x{p['L1p']}x{p['L2p']}"


def row_blocks(p, reps):
    """The row kernel under every block size that fits p's width, each held
    bitwise against the plain version: {columns per thread: (threads,
    ms)}."""
    from kalign_tpu_torch.gpu import gotoh_row
    prep = gotoh_row.prepare(p["pc"], p["pr"], p["la"], p["lb"], p["slope"],
                             p["eps"])
    args = (p["match"], prep, p["la"], p["lb"])
    ref = gotoh_row.launch(*args)
    out = {}
    for ch in gotoh_row.CHUNKS:
        cfg = gotoh_row.config_for(p["L2p"], ch)
        if cfg is None:
            continue
        run = lambda: gotoh_row.launch(*args, config=cfg)
        hold_dp_outputs("gotoh_row", False, run(), ref, p,
                        f"{shape_of(p)} under {cfg}")
        out[ch] = (cfg.threads, cuda_time_ms(run, reps=reps))
    return out


def distance_stage(seqs, dev):
    """The anchor-distance stage of engine.align_msa for seqs: encoded,
    sorted and anchored as the engine does it.  Returns (PairBatch, the
    sequences' lengths)."""
    from kalign_tpu_torch import engine as E
    from kalign_tpu_torch.core import alphabet as alpha
    from kalign_tpu_torch.core import params as P
    from kalign_tpu_torch.core.msa import Msa
    from kalign_tpu_torch.gpu import distances
    msa = Msa.from_sequences(list(seqs))
    msa.quiet = True
    msa.sort_len_name()
    msa.encode(alpha.ALPHA_DEFAULT_DNA if msa.biotype == P.BIOTYPE_DNA
               else alpha.ALPHA_REDUCED_PROTEIN)
    anchors = E.pick_anchors(msa)
    codes = [sq.s for sq in msa.sequences]
    lens = np.array([len(c) for c in codes], np.int32)
    tokens = np.zeros((len(codes), int(lens.max())), np.uint8)
    for i, c in enumerate(codes):
        tokens[i, :len(c)] = c
    pairs = distances.anchor_pairs(len(codes), anchors)
    return distances.PairBatch(tokens, lens, *pairs, dev), lens


def bpm_stage(dev, seqs):
    """The BPM kernel and its mask-table kernel at the pairs of seqs'
    distance stage, each held bitwise against its plain version (on the
    card) and timed: {"bpm": ..., "bpm_table": ...}.  Bounds: BPM reads
    each sequence's tokens, the table and 16 bytes of index vectors per
    pair, writes 4 bytes per pair and does BPM_OPS_PER_BLOCK_STEP 32-bit
    integer operations per (pair, symbol, live block) step this data
    needs; the table kernel reads each row's tokens up to nblk*64 and its
    length, writes the table and compares every pattern position with
    every symbol."""
    import torch
    from kalign_tpu_torch.gpu import bpm
    pairs, lens = distance_stage(seqs, dev)
    tok, ti, pi, nn, mm, table = inp = pairs.inputs(0, pairs.n_pairs)
    P, N, nblk = pairs.n_pairs, len(lens), pairs.nblk
    shape = f"{N}x{P // N} pairs, nblk={nblk}"
    m_seq = torch.from_numpy(np.minimum(lens, bpm.MAX_PATTERN)).to(dev)
    ref_table, t_plain_ms = timed_once(
        lambda: bpm.plain_table(tok, m_seq, nblk))
    hold_equal("bpm_table", table, ref_table, f"{N} rows, nblk={nblk}")
    run_table = lambda: bpm.launch_table(tok, m_seq, nblk)
    t_bytes = (int(np.minimum(lens, bpm.WORD * nblk).sum()) + N * 4
               + table.numel() * 8)
    tb_ms, tb_by = bound(t_bytes, table.numel() * bpm.WORD, INT32_OPS_PER_S)
    got = bpm.launch(*inp)
    (ref, work), plain_ms = timed_once(
        lambda: bpm.plain(*inp, count_work=True))
    hold_equal("bpm", got, ref, f"{shape} at a distance stage's pairs")
    run = lambda: bpm.launch(*inp)
    b_ms, b_by = bound(int(lens.sum()) + table.numel() * 8 + P * 20,
                       work * BPM_OPS_PER_BLOCK_STEP, INT32_OPS_PER_S)
    return {
        "bpm": dict(ms=cuda_time_ms(run, reps=20),
                    device_ms=device_ms(run, 10), plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, shape=shape,
                    block_steps=work, plan=bpm.launch_plan(nblk)._asdict()),
        "bpm_table": dict(ms=cuda_time_ms(run_table, reps=20),
                          device_ms=device_ms(run_table, 20),
                          plain_ms=t_plain_ms, bound_ms=tb_ms,
                          bound_by=tb_by, shape=f"{N}x{bpm.SIGMA}x{nblk}")}


def bpm_table_shape(dev, seqs):
    """The mask-table kernel alone at the rows of seqs (their lengths;
    random codes, on which the table depends only through equality), nblk
    the words their longest pattern needs: held bitwise against its plain
    version on the card, timed, with bpm_stage's bound."""
    import torch
    from kalign_tpu_torch.gpu import bpm
    lens = np.array([len(x) for x in seqs], np.int32)
    m = np.minimum(lens, bpm.MAX_PATTERN).astype(np.int32)
    nblk = -(-int(m.max()) // bpm.WORD)
    tokens = random_tokens(np.random.default_rng(len(lens)), lens)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    tok = t(np.pad(tokens, ((0, 0), (0, -tokens.shape[1] % 16))))
    m_seq = t(m)
    run = lambda: bpm.launch_table(tok, m_seq, nblk)
    table = run()
    ref, plain_ms = timed_once(lambda: bpm.plain_table(tok, m_seq, nblk))
    shape = f"{len(lens)}x{bpm.SIGMA}x{nblk}"
    hold_equal("bpm_table", table, ref, f"{shape} words")
    b_ms, b_by = bound(int(np.minimum(lens, bpm.WORD * nblk).sum())
                       + len(lens) * 4 + table.numel() * 8,
                       table.numel() * bpm.WORD, INT32_OPS_PER_S)
    return dict(ms=cuda_time_ms(run, reps=20), device_ms=device_ms(run, 20),
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, shape=shape)


def launch_memory(dev):
    """Peak device bytes per DP cell of one GpuEngine.launch_bucket on the
    row route (8 problems of 1,024 x 8,192, the cluster kernel's widths),
    without and with a consistency bonus of 5 anchors, and from each the
    widest square problem (a multiple of 128) of which one launch of 8
    problems fits in this card's memory; then one problem of 8,192 x
    131,072 on the wave route with a bonus: its peak bytes beside
    engine.problem_bytes (the memory guard's model), and the widest
    square problem of which one fits by that model."""
    import torch
    from kalign_tpu_torch.gpu import engine as E
    from kalign_tpu_torch.gpu.engine import GpuEngine
    eng = GpuEngine(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(3)

    def rnd(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def peak(B, L1p, L2p, K, bonus):
        lhs, rhs = rnd(B, L1p, 23), rnd(B, L2p, 23)
        pc, pr = -rnd(B, 3, L2p + 1) - 0.5, -rnd(B, 3, L1p + 1) - 0.5
        la = torch.full((B,), L1p, dtype=torch.int32, device=dev)
        lb = torch.full((B,), L2p, dtype=torch.int32, device=dev)
        eps = torch.full((B,), 1e-3, device=dev)
        pos = lambda L: (torch.arange(L, device=dev, dtype=torch.int32)
                         .expand(B, K, L).contiguous())
        bn = (torch.tensor(0.4, device=dev), pos(L1p), rnd(B, K, L1p),
              pos(L2p), rnd(B, K, L2p)) if bonus else None
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        eng.launch_bucket(lhs, rhs, pc, pr, la, lb, eps, bn,
                          la.cpu().numpy(), lb.cpu().numpy())
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(dev) - base

    B, L1p, L2p, K = 8, 1024, 8192, 5
    total = torch.cuda.get_device_properties(dev).total_memory
    out = {"total_bytes": total}
    # once unmeasured: the first product also allocates cuBLAS's workspace
    peak(B, L1p, L2p, K, False)
    for key, bonus in (("no_bonus", False), ("bonus", True)):
        per_cell = peak(B, L1p, L2p, K, bonus) / (B * L1p * L2p)
        out[key] = {"bytes_per_cell": per_cell, "widest_square_8": int(
            (total / (8 * per_cell)) ** 0.5) // 128 * 128}
    out["bonus_over_no_bonus"] = (out["bonus"]["bytes_per_cell"]
                                  - out["no_bonus"]["bytes_per_cell"])
    if out["bonus_over_no_bonus"] > 0.5:
        raise AssertionError(f"a wide launch with a bonus takes "
                             f"{out['bonus_over_no_bonus']} bytes a cell "
                             "more than one without")
    L1w, L2w = 8192, 131072
    got = peak(1, L1w, L2w, K, True)
    L = 128
    while E.problem_bytes(L + 128, L + 128) <= total and \
            L + 128 <= 917504:
        L += 128
    out["wave_one_problem"] = {
        "shape": f"1x{L1w}x{L2w}", "peak_bytes": got,
        "problem_bytes": E.problem_bytes(L1w, L2w),
        "bytes_per_cell": got / (L1w * L2w), "widest_square_1": L}
    torch.cuda.empty_cache()
    return out


def batch_cells(b):
    """The DP cells a launch's problems need (la x lb each)."""
    return int(np.sum(b["la"].astype(np.int64) * b["lb"]))


def row_dp_entry(name, p, reps):
    """The row kernel's wrapper at problem p under its launch_config plan:
    held bitwise against the plain version, timed, with its bound."""
    from kalign_tpu_torch.gpu import gotoh_row
    _, ms, dev_ms, plain_ms = hold_dp(name, gotoh_row, False, p, reps)
    b_ms, b_by = gotoh_bound(p, 1)
    return dict(shape=shape_of(p), ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                plan=gotoh_row.launch_config(len(p["la"]),
                                             p["L2p"])._asdict())


def cluster_main_shape(dev, stats_wide, stats_long=None):
    """The cluster row kernel at the long_default path's largest map-DP
    launch and its largest progressive launch (by the cells their lengths
    need), at the long family's largest cluster launch (stats_long), and
    at 8 x 512 x 8,192 and 2 x 256 x 16,384 at full lengths: each held
    bitwise against the plain version and timed; with the device memory
    one wide launch of the engine takes (launch_memory)."""
    from kalign_tpu_torch.gpu import gotoh_row
    rng = np.random.default_rng(2)

    def largest(st, maps=None):
        return max((b for b in st["batches"] if b["route"] == "row"
                    and maps in (None, b["maps"])
                    and gotoh_row.launch_config(
                        len(b["la"]), b["L2p"]).route == "cluster"),
                   key=batch_cells)

    def problem(b):
        return dp_problem(rng, b["L1p"], b["L2p"], b["la"], b["lb"], dev)
    name = "gotoh_row_cluster"
    out = row_dp_entry(name, problem(largest(stats_wide, True)), 3)
    out["progressive"] = row_dp_entry(name,
                                      problem(largest(stats_wide, False)), 3)
    if stats_long is not None:
        out["long_family"] = row_dp_entry(name, problem(largest(stats_long)),
                                          5)
        out["8192"] = row_dp_entry(name, dp_problem(
            rng, 512, 8192, [512] * 8, [8192] * 8, dev), 5)
        out["16384"] = row_dp_entry(name, dp_problem(
            rng, 256, 16384, [256] * 2, [16384] * 2, dev), 5)
        out["launch_memory"] = launch_memory(dev)
    emit({"phase": "main_shape", "kernel": name, **out})
    return out


@contextmanager
def recorded_wave_calls(seen):
    """gotoh_wave.forward_operands's arguments (the engine's launch
    batches on the wave route) appended to seen."""
    from kalign_tpu_torch.gpu import gotoh_wave
    orig = gotoh_wave.forward_operands

    def rec(*args, **kw):
        if args[7] is not None:      # a merge (the maps have no bonus)
            seen.append((args, kw))
        return orig(*args, **kw)
    gotoh_wave.forward_operands = rec
    try:
        yield
    finally:
        gotoh_wave.forward_operands = orig


def root_merge(seen):
    """The widest merge (a call with a bonus) the wave route took: its one
    problem's operands (lhs, rhs, pc, pr, la, lb, eps, bonus), each with a
    batch of 1."""
    best = None
    for args, _ in seen:
        lhs, rhs, pc, pr, la, lb, eps, bonus = args[:8]
        if bonus is None:
            continue
        for b in range(lhs.shape[0]):
            cells = int(la[b]) * int(lb[b])
            if best is None or cells > best[0]:
                one = lambda x: x[b:b + 1]
                best = (cells, tuple(one(x) for x in (
                    lhs, rhs, pc, pr, la, lb, eps)) + ((bonus[0],) + tuple(
                        one(v) for v in bonus[1:]),))
    if best is None:
        raise AssertionError("no merge took the wave route")
    return best[1]


def hold_wave_block(got_dec, got_state, want_dec, want_state, what):
    """A block of rows: decisions (every column) and its last row's state
    [3, L2p] bit for bit."""
    import torch
    ok = torch.equal(got_dec, want_dec) and torch.equal(
        got_state.view(torch.int32), want_state.view(torch.int32))
    hold("gotoh_row_wave", ok, abs_err(got_state, want_state), what)


def wave_root(dev, seen):
    """The plastome_default path's root merge on the wave route
    (gotoh_wave.operand_source: each block of rows' fp32 product and
    prepare_match in place, then the wave kernel), block by block on one
    stream: the first two blocks of rows and the last held bitwise
    against the plain version (one unit over the whole row) from the same
    state (decisions, the block's last state; the score and end state
    from the last), every launch timed by CUDA events and the whole run's
    wall.  Then the route as the engine runs it (gotoh_wave.launch, the
    next block made on a second stream), its score and end state held to
    the first run's, its launches' device time and its wall.  Then the
    first two blocks' rows
    as a problem of their own (la = their rows) through the wave and
    through PR 14's band pipeline (gotoh_mesh.forward on MESH_SHARDS
    shards of this card): held against each other, device time and the
    pipeline's host enqueue beside each other.  Returns the wave's
    kernels-line entry."""
    import torch
    import torch.nn.functional as F
    from kalign_tpu_torch.gpu import gotoh_mesh, gotoh_row, gotoh_wave
    lhs, rhs, pc, pr, la, lb, eps, bonus = root_merge(seen)
    L1p, L2p = lhs.shape[1], rhs.shape[1]
    la_i, lb_i = int(la[0]), int(lb[0])
    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    prep = gotoh_row.prepare(pc, pr, la, lb, zero, zero)
    source = gotoh_wave.operand_source(lhs, rhs, la, lb, eps, bonus)
    torch.cuda.empty_cache()
    with torch.cuda.device(dev):
        cfg = gotoh_wave.checked_plan(L2p)
        # the first plan's clusters the card holds at once (below its
        # bands, schedulable re-planned)
        first = gotoh_row.wave_config(L2p)
        held = gotoh_wave.max_active(first)
    R = gotoh_wave.block_rows(L1p, L2p)
    n = min(la_i, L1p)
    starts = list(range(0, n, R))
    K = len(starts)
    keep = {0, 1, 2, K - 1} & set(range(K))
    buf = gotoh_wave.Buffers(prep, 0, cfg, R)
    dec = torch.empty((L1p, L2p), dtype=torch.int8, device=dev)
    before, events = {}, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k, r0 in enumerate(starts):
        if k in keep:
            before[k] = buf.state[k & 1][:, :L2p].clone()
        m = source(0, r0, min(r0 + R, n))
        events.append([torch.cuda.Event(enable_timing=True)
                       for _ in range(2)])
        events[-1][0].record()
        gotoh_wave.launch_block(m, prep, 0, buf, dec, r0, k, la, lb, cfg)
        events[-1][1].record()
        m = None
    torch.cuda.synchronize()
    route_ms = (time.perf_counter() - t0) * 1e3
    kernel_ms = sum(e0.elapsed_time(e1) for e0, e1 in events)
    final = buf.state[K & 1][:, :L2p]
    # the held blocks against the plain version from the same state (row
    # 0's the plain version's own)
    hold_bits("gotoh_row_wave", before[0], gotoh_wave.plain_state(prep, 0),
              "the root merge's row 0 state")
    held_ms, held_cells = 0.0, 0
    for k in sorted({0, 1, K - 1} & set(range(K))):
        r0 = starts[k]
        r1 = min(r0 + R, n)
        m = source(0, r0, r1)
        (want_dec, want_state), ms = timed_once(
            lambda: gotoh_wave.plain_block(m, prep, 0, before[k], r0, la_i,
                                           lb_i, L2p))
        held_ms += ms
        held_cells += (r1 - r0) * lb_i
        after = before.get(k + 1, final if k == K - 1 else None)
        hold_wave_block(dec[r0:r1], after, want_dec, want_state,
                        f"the plastome root merge 1x{L1p}x{L2p}, block {k} "
                        f"of {K} (rows {r0}-{r1 - 1})")
        if k == K - 1:
            s_w, st_w = gotoh_wave.end_values(want_state, lb)
            s_k, st_k = gotoh_wave.end_values(final, lb)
            hold_bits("gotoh_row_wave", s_k, s_w, "the root merge's score")
            hold_equal("gotoh_row_wave", st_k, st_w,
                       "the root merge's end state")
    held_kernel_ms = sum(events[k][0].elapsed_time(events[k][1])
                         for k in sorted({0, 1, K - 1} & set(range(K))))
    b_all, by_all = bound(float(n) * lb_i * 5, float(n) * lb_i *
                          GOTOH_OPS_PER_CELL, FP32_OPS_PER_S)
    b_held, by_held = bound(held_cells * 5.0, held_cells * GOTOH_OPS_PER_CELL,
                            FP32_OPS_PER_S)
    s_k, st_k = gotoh_wave.end_values(final, lb)
    del dec, buf, m, before, final
    torch.cuda.empty_cache()

    # the route as the engine runs it (gotoh_wave.launch: the next block's
    # match made on a second stream while the kernel runs), each launch
    # timed by events; its score and end state the held run's
    ev = []
    (_, s_r, st_r), eng_ms = timed_once(lambda: gotoh_wave.launch(
        source, prep, la, lb, la_h=[la_i], events=ev))
    hold_bits("gotoh_row_wave", s_r, s_k, "the root merge's score, the "
              "engine's route against the held run")
    hold_equal("gotoh_row_wave", st_r, st_k, "the root merge's end state, "
               "the engine's route against the held run")
    eng_kernel_ms = sum(e0.elapsed_time(e1) for e0, e1 in ev)
    torch.cuda.empty_cache()

    # the first two blocks' rows as a problem of their own: the wave and
    # PR 14's band pipeline on shards of this card
    rows2 = min(2 * R, n)
    mm = torch.cat([source(0, 0, min(R, rows2)), source(0, R, rows2)])[
        :rows2].contiguous()
    la2 = torch.tensor([rows2], dtype=torch.int32, device=dev)
    pr2 = pr[:, :, :rows2 + 1].contiguous()
    prep2 = gotoh_row.prepare(pc, pr2, la2, lb, zero, zero)
    wave = lambda: gotoh_wave.launch(lambda b, r0, r1, out=None: mm[r0:r1],
                                     prep2, la2, lb, cfg, R, la_h=[rows2])
    wave_out = wave()
    wave_ms = device_ms(wave, 2)
    mesh = mesh_of()
    Wd = gotoh_mesh.band_width(L2p, mesh.size,
                               gotoh_mesh.alone(mesh.shards))
    Wp = Wd * mesh.size
    mp = F.pad(mm, (0, Wp - L2p))
    bands = [mp[:, d * Wd:(d + 1) * Wd].to(sh.device).contiguous()
             for d, sh in enumerate(mesh.shards)]
    del mp
    prep_m = gotoh_row.prepare(F.pad(pc, (0, Wp - L2p)), pr2, la2, lb, zero,
                               zero)
    # made on the default stream: done before the shards' streams read
    torch.cuda.synchronize()
    got = band_run(mesh, bands, prep_m, Wp, rows2, lb_i)
    hold_band(f"the root merge's first {rows2} rows: the band pipeline vs "
              "the wave", got, (wave_out[0][0], wave_out[1], wave_out[2]),
              rows2, lb_i, "gotoh_row_wave")
    mesh_ms, mesh_enqueue = band_device_ms(mesh, (bands, prep_m, Wp), rows2,
                                           lb_i)
    band_cfg = gotoh_mesh.band_config(Wd, gotoh_mesh.alone(mesh.shards))
    b2, by2 = bound(float(rows2) * lb_i * 5, float(rows2) * lb_i *
                    GOTOH_OPS_PER_CELL, FP32_OPS_PER_S)
    del bands, mm
    torch.cuda.empty_cache()
    shape = f"1x{L1p}x{L2p} la={la_i} lb={lb_i}"
    return dict(
        shape=f"{shape}, blocks 0, 1 and {K - 1} of {K} ({R} rows each)",
        ms=round(held_kernel_ms, 3), plain_ms=round(held_ms, 3),
        bound_ms=b_held, bound_by=by_held, library_ms=None,
        plan=cfg._asdict(), rows_per_launch=R, every=gotoh_wave.EVERY,
        first_plan=first._asdict(), first_plan_max_active_clusters=held,
        plan_max_active_clusters=gotoh_wave.max_active(cfg),
        root_merge=dict(shape=shape, launches=K,
                        kernel_ms=round(eng_kernel_ms, 3),
                        route_ms=round(eng_ms, 3),
                        us_per_row=round(eng_kernel_ms * 1e3 / n, 4),
                        serial_kernel_ms=round(kernel_ms, 3),
                        serial_route_ms=round(route_ms, 3),
                        bound_ms=b_all, bound_by=by_all),
        vs_band_pipeline=dict(
            shape=f"1x{rows2}x{L2p} lb={lb_i}", wave_device_ms=round(
                wave_ms, 3), band_device_ms=round(mesh_ms, 3),
            band_enqueue_ms=round(mesh_enqueue, 3), shards=mesh.size,
            cards=mesh.cards, band=Wd, band_route=band_cfg.route,
            band_blocks=band_cfg.blocks, bound_ms=b2, bound_by=by2))


def wave_main_shape(dev, seen):
    """The wave route at 1 x 64 x 131,072 (where PR 6's tiled kernel took
    dev. 20.02 ms): held against the plain row DP, timed (events, then
    device_ms) beside its plain version and bound; then the plastome root
    merge (wave_root), whose held blocks give the kernels-line numbers."""
    out = wave_root(dev, seen)
    out["131072"] = row_dp_entry("gotoh_row_wave", dp_problem(
        np.random.default_rng(3), 64, 131072, [64], [131072], dev), 5)
    emit({"phase": "main_shape", "kernel": "gotoh_row_wave", **out})
    return out


# a serve-path launch of the match preparation: the eight-problem
# launches of the protein families' upper levels (B x L1p x L2p)
PREPARE_SERVE = (8, 384, 384)


def prepare_main_shape(dev, seen, stats_long):
    """The match-preparation kernel at the plastome root merge's first
    block of rows (its own bonus, row0 0), at long_default's largest
    progressive launch (its lengths, random anchor vectors of K = 5) and
    at a serve-path launch (PREPARE_SERVE, random lengths and anchors of
    K = 5): each held bitwise against its plain version (on the same card
    tensors) and timed, in place (events; device_ms), beside the plain
    version and the bytes bound (8 bytes a cell, the anchor vectors),
    with its launch plan."""
    import torch
    from kalign_tpu_torch.gpu import gotoh_wave, prepare
    lhs, rhs, pc, pr, la, lb, eps, bonus = root_merge(seen)
    R = gotoh_wave.block_rows(lhs.shape[1], rhs.shape[1])

    def entry(match, la, lb, eps, bonus, what):
        B, Rr, W = match.shape
        K = bonus[1].shape[1]
        want, plain_ms = timed_once(
            lambda: prepare.bonus_match(match, la, lb, eps, bonus))
        got = prepare.prepare_match(match.clone(), la, lb, eps, bonus)
        hold_bits("prepare_match", got, want, what)
        del want
        work = match.clone()
        run = lambda: prepare.launch(work, la, lb, eps, bonus)
        b_ms, b_by = bound(B * Rr * W * 8.0 + B * K * (Rr + W) * 8.0,
                           B * Rr * W * (5.0 + 2 * K), FP32_OPS_PER_S)
        return dict(shape=f"{B}x{Rr}x{W} K={K}", ms=cuda_time_ms(run, 5),
                    device_ms=device_ms(run, 5), plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    plan=prepare.launch_plan(B, Rr, W)._asdict())
    m = torch.bmm(lhs[:, :R], rhs.transpose(1, 2))
    out = entry(m, la, lb, eps, prepare.cut(bonus, 0, R),
                "the plastome root merge's first block of rows")
    del m
    rng = np.random.default_rng(6)
    t = lambda x: torch.from_numpy(np.asarray(x)).to(dev)
    B, L1p, L2p = PREPARE_SERVE
    out["serve"] = entry(
        t(rng.standard_normal((B, L1p, L2p), dtype=np.float32) * 3),
        t(rng.integers(L1p - 127, L1p + 1, B).astype(np.int32)),
        t(rng.integers(L2p - 127, L2p + 1, B).astype(np.int32)),
        torch.full((B,), 1e-3, device=dev),
        bonus_block(rng, B, L1p, L2p, 5, dev), "a serve-path launch")
    if stats_long is None:
        emit({"phase": "main_shape", "kernel": "prepare_match", **out})
        return out
    b = max((b for b in stats_long["batches"] if b["route"] == "row"
             and not b["maps"]), key=batch_cells)
    B, L1p, L2p = len(b["la"]), b["L1p"], b["L2p"]
    m = t(rng.standard_normal((B, L1p, L2p), dtype=np.float32) * 3)
    out["long_default"] = entry(
        m, t(b["la"].astype(np.int32)), t(b["lb"].astype(np.int32)),
        torch.full((B,), 1e-3, device=dev), bonus_block(rng, B, L1p, L2p, 5,
                                                        dev),
        "long_default's largest progressive launch")
    del m
    torch.cuda.empty_cache()
    emit({"phase": "main_shape", "kernel": "prepare_match", **out})
    return out


def phase_main_shapes(dev, stats, stats_default, seqs):
    """Each kernel at the shapes and lengths a path gave it: the row,
    lanewise, traceback and prefix-sum kernels at the fast path's, the
    fused kernel at the default path's, BPM and its table at both paths'
    and at one full chunk of raw_distances (the cluster row kernel, the
    wave route and the match preparation: cluster_main_shape,
    wave_main_shape, prepare_main_shape)."""
    import torch
    from kalign_tpu_torch.core import params as P
    from kalign_tpu_torch.gpu import gotoh_fused, gotoh_lanewise, gotoh_row, \
        scan
    from kalign_tpu_torch.gpu import traceback as tb
    from kalign_tpu_torch.gpu.engine import leaf_operands
    rng = np.random.default_rng(1)
    out = {}

    def batch(lanewise, key, st=stats, route=None):
        route = route or ("lanewise" if lanewise else "row")
        return max((b for b in st["batches"] if b["route"] == route),
                   key=key)

    def problem(b):
        return dp_problem(rng, b["L1p"], b["L2p"], b["la"], b["lb"], dev)

    # row kernel: its largest launch (by the cells its lengths need), its
    # widest, and the default path's largest launch of few problems (an
    # upper tree level); each timed under launch_config's block and under
    # every other block that fits
    p = problem(batch(False, batch_cells))
    row_out, ms, dev_ms, plain_ms = hold_dp("gotoh_row", gotoh_row, False,
                                            p, 20)
    out["gotoh_row"] = dict(ms=ms, plain_ms=plain_ms, shape=shape_of(p),
                            device_ms=dev_ms,
                            block=gotoh_row.launch_config(
                                len(p["la"]), p["L2p"])._asdict(),
                            by_block=row_blocks(p, 20))
    out["gotoh_row"]["bound_ms"], out["gotoh_row"]["bound_by"] = \
        gotoh_bound(p, 1)
    for key, b, reps in (
            ("widest", batch(False, lambda b: (b["L2p"], b["L1p"])), 5),
            ("few", batch(False, lambda b: (-len(b["la"]), batch_cells(b)),
                          stats_default), 10)):
        pk = problem(b)
        _, k_ms, k_dev_ms, k_plain_ms = hold_dp("gotoh_row", gotoh_row,
                                                False, pk, reps)
        b_ms, b_by = gotoh_bound(pk, 1)
        out["gotoh_row"][key] = dict(
            shape=shape_of(pk), ms=k_ms, plain_ms=k_plain_ms,
            device_ms=k_dev_ms, bound_ms=b_ms,
            bound_by=b_by, block=gotoh_row.launch_config(
                len(pk["la"]), pk["L2p"])._asdict(),
            by_block=row_blocks(pk, reps))
        if key == "widest":
            pw = pk
    emit({"phase": "main_shape", "kernel": "gotoh_row", **out["gotoh_row"]})

    # lanewise kernel: the main path's 1,024-problem leaf bucket
    q = problem(batch(True, batch_cells))
    out["gotoh_lanewise"] = {}
    lw_out, ms, dev_ms, _ = hold_dp("gotoh_lanewise", gotoh_lanewise, True,
                                    q, 10, out["gotoh_lanewise"])
    out["gotoh_lanewise"].update(
        ms=ms, shape=shape_of(q), device_ms=dev_ms,
        plan=gotoh_lanewise.launch_plan(q["L2p"])._asdict())
    out["gotoh_lanewise"]["bound_ms"], out["gotoh_lanewise"]["bound_by"] = \
        gotoh_bound(q, 0.5)
    emit({"phase": "main_shape", "kernel": "gotoh_lanewise",
          **out["gotoh_lanewise"]})

    # traceback: walks of the two buckets' decisions, each layout timed on
    # its own, and of the widest row launch's; `ms` and its bound are the
    # two buckets' sum.  Each beside its chain floor, from this card's
    # memory latencies (phase line only: the floor is not a bound)
    pw_out = gotoh_row.launch(pw["match"], gotoh_row.prepare(
        pw["pc"], pw["pr"], pw["la"], pw["lb"], pw["slope"], pw["eps"]),
        pw["la"], pw["lb"])
    latencies = memory_latencies_ms(dev)
    walks, floors = {}, {}
    for key, lanewise, r, (dec, _, st) in (
            ("rows", False, p, row_out), ("lanewise", True, q, lw_out),
            ("widest", False, pw, pw_out)):
        walk, plain = ((tb.walk_lanewise, tb.plain_lanewise) if lanewise
                       else (tb.walk_rows, tb.plain_rows))
        args = (dec, r["la"], r["lb"], st, r["L1p"] + r["L2p"] + 2)
        got = walk(*args)
        ref, t_plain = timed_once(lambda: plain(*args))
        hold_walks(got, ref, r["la"], r["lb"],
                   f"{walk.__name__} {shape_of(r)} at the main path's shape")
        # one decision byte read per step, the step rows written, and
        # la, lb, the end state and n
        b_ms, b_by = bound(int(got[1].sum()) + got[0].numel()
                           + len(r["la"]) * 16, 0, FP32_OPS_PER_S)
        walks[key] = dict(
            shape=shape_of(r), ms=cuda_time_ms(lambda: walk(*args), reps=20),
            device_ms=device_ms(lambda: walk(*args), 10),
            plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
            plan=tb.launch_plan(len(r["la"]), args[4])._asdict())
        floors[key] = walk_chain_floor(args, lanewise, latencies)
    out["traceback"] = dict(
        ms=walks["rows"]["ms"] + walks["lanewise"]["ms"],
        device_ms=walks["rows"]["device_ms"] + walks["lanewise"]["device_ms"],
        plain_ms=walks["rows"]["plain_ms"] + walks["lanewise"]["plain_ms"],
        bound_ms=walks["rows"]["bound_ms"] + walks["lanewise"]["bound_ms"],
        bound_by="bytes", shape=f"{walks['rows']['shape']} rows + "
        f"{walks['lanewise']['shape']} lanewise", **walks)
    emit({"phase": "main_shape", "kernel": "traceback", **out["traceback"],
          "chain_floor": floors,
          "memory_latency_ms": latencies})

    # prefix sums: the row-side terminal-gap run of the leaf bucket, as
    # gotoh_lanewise.prepare takes it (a strided view), and the column gap
    # extensions of the widest row launch, as gotoh_row.prepare takes them
    out["prefix_sum"] = {}
    for key, x in (("leaf", q["pr"][:, 2, 1:]),
                   ("widest", pw["pc"][:, 1, 1:])):
        got = scan.prefix_sum_f32(x)
        ref, plain_ms = timed_once(lambda: scan.plain(x))
        hold_equal("prefix_sum", got, ref, f"{tuple(x.shape)} at the main "
                   "path's shape")
        b_ms, b_by = bound(x.numel() * 8, x.numel(), FP32_OPS_PER_S)
        cumsum = lambda: torch.cumsum(x, dim=1)
        t = dict(ms=cuda_time_ms(lambda: scan.launch(x), reps=50),
                 plain_ms=plain_ms, library_ms=cuda_time_ms(cumsum, reps=50),
                 device_ms=device_ms(lambda: scan.launch(x), 50),
                 library_device_ms=device_ms(cumsum, 50),
                 bound_ms=b_ms, bound_by=b_by,
                 shape=f"{x.shape[0]}x{x.shape[1]}")
        if key == "leaf":
            out["prefix_sum"].update(t)
        else:
            out["prefix_sum"][key] = t
    emit({"phase": "main_shape", "kernel": "prefix_sum",
          **out["prefix_sum"]})

    # BPM and its mask table at each path's N x 32 pairs, and at one full
    # raw_distances chunk: 8,192 protein sequences x 32 anchors
    stages = {key: bpm_stage(dev, s) for key, s in (
        ("fast", seqs["fast"]), ("default", seqs["default"]),
        ("full_chunk", family(8192, seed=4)))}
    # the table alone at the large path's 16,384 rows and at a genome
    # path's nblk 16 (long_default's 128 rows of ~9,720 nt)
    tables = {key: bpm_table_shape(dev, seqs[path]) for key, path in (
        ("large", "large_default"), ("genome", "long_default"))}
    for name in ("bpm", "bpm_table"):
        out[name] = dict(stages["fast"][name], **{
            key: stages[key][name] for key in ("default", "full_chunk")})
        if name == "bpm_table":
            out[name].update(tables)
        emit({"phase": "main_shape", "kernel": name, **out[name]})

    # fused kernel: every launch shape of the default path (map DPs), the
    # largest launch of each, with its real lengths, the engine's own
    # operands (one-hot rows against rows of the DNA substitution matrix,
    # integer-valued) from random nucleotide codes, the map DPs'
    # penalties and eps = 0.  Each launch is held against the plain
    # version on the CPU (in a host worker: later), the largest (4,096
    # problems) also against the materialised route
    ap = P.aln_param_init(P.BIOTYPE_DNA, 0)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    nc = 5
    shapes = {}
    for b in stats_default["batches"]:
        if b["route"] == "fused":
            key = (len(b["la"]), b["L1p"], b["L2p"])
            if key not in shapes or batch_cells(b) > batch_cells(shapes[key]):
                shapes[key] = b
    launches_f = []
    for k, ((B, L1p, L2p), fb) in enumerate(sorted(
            shapes.items(), key=lambda kv: -batch_cells(kv[1]))):
        la_d, lb_d = t(fb["la"]), t(fb["lb"])
        tok = t(rng.integers(0, 4, size=(2 * B, max(L1p, L2p)))
                .astype(np.uint8))
        lhs, rhs, pc, pr = leaf_operands(
            tok, t(np.asarray(ap.subm, np.float32)),
            t(np.array([-ap.gpo, -ap.gpe, -ap.tgpe], np.float32)),
            t(np.arange(B, dtype=np.int32)),
            t(np.arange(B, 2 * B, dtype=np.int32)), la_d, lb_d, L1p, L2p)
        x, y = lhs[:, :, :nc].contiguous(), rhs[:, :, :nc].contiguous()
        slope = lb_d.float() / torch.clamp(la_d.float(), min=1.0)
        prep = gotoh_fused.prepare(pc, pr, la_d, lb_d, slope,
                                   torch.zeros(B, device=dev))
        f = dict(la=la_d, lb=lb_d, L1p=L1p, L2p=L2p)
        run = lambda: gotoh_fused.launch(x, y, prep, la_d, lb_d)
        got = run()
        shape = f"{B}x{L1p}x{L2p}"
        b_ms, b_by = gotoh_bound(f, 0.5, nc)
        entry = dict(shape=shape, ms=cuda_time_ms(run, reps=10),
                     device_ms=device_ms(run, 5),
                     bound_ms=b_ms, bound_by=b_by,
                     plan=gotoh_lanewise.launch_plan(L2p, nc)._asdict())
        hold_dp_later("gotoh_fused", True, got, gotoh_fused.plain,
                      (x, y, prep, la_d, lb_d), f, shape,
                      lambda ms, entry=entry: entry.__setitem__(
                          "plain_ms", ms))
        if k == 0:
            # the materialised route on the same inputs: the 23-wide match
            # product, then the match-stream lanewise kernel; integer
            # operands make the product exact, so it gives the fused
            # route's bits
            def materialised():
                match = torch.bmm(lhs, rhs.transpose(1, 2))
                return gotoh_lanewise.launch(match, prep, la_d, lb_d)
            hold_dp_outputs("gotoh_fused", True, got, materialised(), f,
                            f"{shape} fused vs bmm + lanewise")
            entry["materialised_ms"] = cuda_time_ms(materialised, reps=10)
        launches_f.append(entry)
    # (one dict, which the host workers' checks complete: later)
    out["gotoh_fused"] = launches_f[0]
    out["gotoh_fused"]["other_shapes"] = launches_f[1:]
    emit({"phase": "main_shape", "kernel": "gotoh_fused",
          **out["gotoh_fused"]})
    return out


# the gpu_vs_cpu cases: consistency anchors (how the input is made:
# vs_input); the refine mode of a refined case; the engine where it is not
# the default gpu-fast; the golden file a case must give.  BB30014 (mean
# anchor distance ~0.55) routes to the exact engine in both modes.
VS_CASES = {"BB30014": 0, "family150": 0, "BB30014-autoroute": 5,
            "dna250-default": 5, "long-fast": 0, "long-default": 5,
            "BB11001-refine-all": 0, "BB12006-gpu": 5, "small-precise": 5,
            "small-ensemble3": 5, "BB11001-postrealign2": 0,
            "BB12006-mesh-long": 5, "long-default-wave": 5}
# cases of the ensemble (mode "precise": 3 runs with one realign pass;
# without realign runs 1 and 2 take tree noise) and of post-realign (of
# the golden default alignment, refine confident, 2 iterations); these
# must give the same bytes on the card and on the CPU
VS_ENSEMBLE = {"small-precise": 1, "small-ensemble3": 0}
VS_POST = {"BB11001-postrealign2": ("BB11001.default.afa", "confident", 2)}
VS_REFINE = {"BB11001-refine-all": "all"}
VS_ENGINE = {"BB12006-gpu": "gpu"}
# cases on the engine gpu-mesh, its shards on one device (cuda:0 on the
# card, the CPU there) and every merge on the column-sharded route (the
# width rule forced, as test_mesh_engine_long_seq_route forces kalign_tpu's)
VS_MESH = {"BB12006-mesh-long": 4}
# cases whose DPs past 7,168 columns take the wave route (the cluster
# widths routed to it, as forced_plan forces a band route): the wave
# kernel on the card, its plain version on the CPU
VS_WAVE = {"long-default-wave"}
VS_GOLDEN = {"BB30014-autoroute": "BB30014.default.afa",
             "BB12006-gpu": "BB12006.default.afa"}


def vs_input(name):
    """The input Msa of a gpu_vs_cpu case."""
    from kalign_tpu_torch.core import io as kio
    from kalign_tpu_torch.core.msa import Msa
    if name in VS_POST:
        msa = kio.read_alignment(os.path.join(HERE, "tests", "golden",
                                              VS_POST[name][0]))
    elif name.startswith("small"):
        msa = kio.read_inputs([os.path.join(HERE, "tests", "data",
                                            "small.fa")])
    elif name.startswith("BB"):
        msa = kio.read_alignment(os.path.join(HERE, "tests", "data",
                                              name.split("-")[0] + ".tfa"))
    elif name == "family150":
        msa = Msa.from_sequences(family(150, seed=1))
    elif name == "dna250-default":
        # 100-128 nt: its 1,245 map DPs fill one 2,048-problem launch of
        # the fused route at 128 x 128, on the card and on the CPU
        msa = Msa.from_sequences(family(
            250, seed=3, root_len=114, lo=100, hi=128, letters=DNA,
            subs=(0.08, 0.04), max_indel=3, p_del=0.6))
    else:
        msa = Msa.from_sequences(long_family(0))
    msa.quiet = True
    return msa


def vs_align(name, device):
    """(FASTA, per-merge scores, fused launch sizes, engine stats) of a
    gpu_vs_cpu case aligned on device; on the CPU in a worker process of
    one thread.  An ensemble case gives its column confidences for the
    scores and its runs' engine for the engine."""
    import torch
    from kalign_tpu_torch import api
    from kalign_tpu_torch import engine as E
    from kalign_tpu_torch import ensemble as ens
    from kalign_tpu_torch.core import io as kio
    if device == "cpu":
        torch.set_num_threads(1)
    engine = VS_ENGINE.get(name, "gpu-fast")
    if name in VS_MESH:
        from kalign_tpu_torch.gpu.engine import GpuEngine
        from kalign_tpu_torch.parallel.mesh import make_mesh
        engine = GpuEngine(mesh=make_mesh(devices=[device] * VS_MESH[name]))
        row_feasible = GpuEngine.__dict__["row_feasible"]
        GpuEngine.row_feasible = staticmethod(lambda B, L2p: False)
        try:
            msa = E.align_msa(vs_input(name),
                              consistency_anchors=VS_CASES[name],
                              engine=engine)
        finally:
            GpuEngine.row_feasible = row_feasible
        return (kio.format_alignment(msa, "fasta"),
                np.asarray(msa.task_confidence, np.float64), [],
                msa.engine_stats)
    if name in VS_WAVE:
        from kalign_tpu_torch.gpu import gotoh_row
        widest = gotoh_row.CLUSTER_MAX_WIDTH
        gotoh_row.CLUSTER_MAX_WIDTH = 7168
        try:
            msa = E.align_msa(vs_input(name),
                              consistency_anchors=VS_CASES[name],
                              engine=engine, device=device)
        finally:
            gotoh_row.CLUSTER_MAX_WIDTH = widest
        return (kio.format_alignment(msa, "fasta"),
                np.asarray(msa.task_confidence, np.float64), [],
                msa.engine_stats)
    if name in VS_ENSEMBLE:
        msa = ens.ensemble_align(vs_input(name), n_runs=3,
                                 realign=VS_ENSEMBLE[name],
                                 consistency_anchors=VS_CASES[name],
                                 engine=engine, device=device)
        runs = msa.engine_stats["ensemble"]["run_engines"]
        return (kio.format_alignment(msa, "fasta"),
                np.asarray(msa.col_confidence, np.float64), [],
                {"engine": ",".join(sorted(set(runs)))})
    if name in VS_POST:
        _, refine, iters = VS_POST[name]
        msa = E.post_realign_msa(vs_input(name),
                                 refine=api._resolve_refine(refine),
                                 realign_iterations=iters, engine=engine,
                                 device=device)
    else:
        msa = E.align_msa(vs_input(name), consistency_anchors=VS_CASES[name],
                          refine=api._resolve_refine(VS_REFINE.get(name)),
                          engine=engine, device=device)
    fused = [len(b["la"]) for b in msa.engine_stats.get("batches", [])
             if b["route"] == "fused"]
    return (kio.format_alignment(msa, "fasta"),
            np.asarray(msa.task_confidence, np.float64), fused,
            msa.engine_stats)


def vs_cpu_sides():
    """The CPU sides of gpu_vs_cpu, handed to the host workers (their
    plain versions are host-bound loops; run_all hands them out after the
    precise path, so that they run while the card takes the phases
    before gpu_vs_cpu)."""
    return {name: host_pool().submit(vs_align, name, "cpu")
            for name in VS_CASES}


def phase_gpu_vs_cpu(cpu=None):
    """Every case on the card and on the CPU (cpu: vs_cpu_sides(), handed
    out here where not given) while the card takes the cases one by
    one."""
    launches, stats = {}, {}
    cpu = cpu or vs_cpu_sides()
    for name, consistency in VS_CASES.items():
        reset_counts()
        outs = {"cuda": vs_align(name, "cuda")}
        launches[name] = read_counts()
        stats[name] = outs["cuda"][3]
        outs["cpu"] = cpu[name].result()
        for d in ("cuda", "cpu"):
            fused = outs[d][2]
            if name.startswith("dna") and fused != [2048]:
                raise AssertionError(f"{name} on {d}: fused launches "
                                     f"{fused}, not one of 2,048")
        same = outs["cuda"][0] == outs["cpu"][0]
        c_gpu, c_cpu = outs["cuda"][1], outs["cpu"][1]
        rel = np.abs(c_gpu - c_cpu) / np.maximum(1.0, np.abs(c_cpu))
        engines = {d: outs[d][3]["engine"] for d in outs}
        golden = None
        if name in VS_GOLDEN:
            with open(os.path.join(HERE, "tests", "golden",
                                   VS_GOLDEN[name])) as fh:
                golden = outs["cuda"][0] == fh.read()
        emit({"phase": "gpu_vs_cpu", "case": name, "engines": engines,
              "identical_fasta": same, "golden_fasta": golden,
              "consistency": consistency,
              "merges": int(len(c_cpu)),
              "merges_with_other_score": int((c_gpu != c_cpu).sum()),
              "max_rel_score_diff": float(rel.max()) if len(rel)
              else 0.0, "launches": launches[name]})
        if not same and rel.max() > 1e-5:
            raise AssertionError(f"{name}: GPU and CPU alignments "
                                 "differ with unequal merge scores")
        if (name in VS_REFINE or name in VS_ENSEMBLE or name in VS_POST
                or "gpu" in engines.values()) and not same:
            raise AssertionError(f"{name}: GPU and CPU alignments "
                                 "differ")
        if name.startswith("BB30014") and \
                set(engines.values()) != {"gpu"}:
            raise AssertionError(f"{name}: not routed to the exact "
                                 f"engine ({engines})")
        if golden is False:
            raise AssertionError(f"{name}: not the golden alignment")
        if name in VS_MESH:
            # every merge on the band kernel, on the card and the CPU
            if not same:
                raise AssertionError(f"{name}: GPU and CPU alignments "
                                     "differ")
            if launches[name]["gotoh_mesh"] + \
                    launches[name]["gotoh_mesh_cluster"] == 0 or \
                    outs["cpu"][3]["long_merges"] == 0:
                raise AssertionError(f"{name}: the column-sharded route "
                                     "did not run")
        if name.startswith("long"):
            # wider than 7,168 columns: card and CPU must agree exactly
            if not same:
                raise AssertionError(f"{name}: GPU and CPU alignments "
                                     "differ")
            route = "gotoh_row_wave" if name in VS_WAVE else \
                "gotoh_row_cluster"
            if launches[name][route] == 0:
                raise AssertionError(f"{name}: {route} did not launch")
            if name in VS_WAVE and launches[name]["gotoh_row_cluster"]:
                raise AssertionError(f"{name}: the cluster row kernel "
                                     "launched")
    return launches, stats


# ---------------------------------------------------------------------------
# the mesh: the engine gpu-mesh, its column-sharded DP (the band kernel)
# and several processes.  Shards: every visible card where there are
# several, else MESH_SHARDS shards on cuda:0, each on its own stream.
MESH_SHARDS = 4
# what the mesh paths must launch and must not: their consistency maps and
# merges take the row kernel (the lanewise and fused routes are off on a
# mesh, tpu/engine.py:264-270); long_default's last levels the band
# kernel's cluster route (bands of ~2,500 columns on 4 shards)
MESH_PATHS = {
    "mesh_default": dict(launch=["bpm", "bpm_table", "prefix_sum",
                                 "traceback", "gotoh_row", "prepare_match"],
                         forbid=["gotoh_lanewise", "gotoh_fused"],
                         gpu_fast="protein_default"),
    "mesh_long": dict(launch=["bpm", "bpm_table", "prefix_sum", "traceback",
                              "gotoh_row_cluster", "gotoh_mesh_cluster",
                              "prepare_match"],
                      forbid=["gotoh_lanewise", "gotoh_fused",
                              "gotoh_row_wave", "gotoh_mesh"],
                      gpu_fast="long_default"),
    # the genome families on the mesh (F6): past 7,168 columns launches of
    # real problems only, each band's match a block of rows at a time; the
    # one-shard run is skipped (one shard is gpu-fast's resident pass,
    # which the gpu_fast path already ran)
    "mesh_sars2": dict(launch=WIDE + ["gotoh_mesh_cluster"] + BONUS,
                       forbid=["gotoh_lanewise", "gotoh_fused",
                               "gotoh_row_wave", "gotoh_mesh"],
                       gpu_fast="sars2_default", one_shard=False),
    "mesh_plastome": dict(launch=GENOME_BASE + ["gotoh_row_wave",
                                                "gotoh_mesh_cluster"] + BONUS,
                          forbid=["gotoh_mesh", "gotoh_lanewise",
                                  "gotoh_fused", "gotoh_row",
                                  "gotoh_row_cluster"],
                          gpu_fast="plastome_default", one_shard=False),
    # a merge wider than 229,376 columns on two shards of a card: bands
    # past 114,688 columns, the band kernel's wave route (no one-shard
    # run: one shard is gpu-fast's resident pass, run here for the FASTA)
    "mesh_wide": dict(launch=GENOME_BASE + ["gotoh_mesh"] + BONUS,
                      forbid=["gotoh_lanewise", "gotoh_fused"],
                      gpu_fast="wide_default", one_shard=False, shards=2),
    # hcmv_genomes over every card (run it with --chips 4): each merge's
    # bands on cards of their own, the map DPs on the first card's wave
    # route (one card holds them)
    "mesh_hcmv": dict(launch=GENOME_BASE + ["gotoh_row_wave",
                                            "gotoh_mesh"] + BONUS,
                      forbid=["gotoh_lanewise", "gotoh_fused", "gotoh_row",
                              "gotoh_row_cluster"],
                      gpu_fast="hcmv_default", one_shard=False)}
# the band kernel's edge cases: (shards, L1, W, la, lb, rows a block)
MESH_EDGE = [(2, 600, 1536, 600, 1536, 256),   # L1 not a multiple of R;
                                               # clusters of 3
             (3, 600, 1000, 555, 1000, 256),   # W not a multiple, la < L1
             (4, 520, 2048, 517, 2000, 128),   # lb < W
             (4, 300, 1024, 300, 100, 64),     # lb inside the first band;
                                               # clusters of 1
             (3, 200, 700, 0, 700, 64),        # la = 0
             (2, 200, 512, 150, 0, 64),        # lb = 0
             # bands of 2,496 columns (not a multiple of 128) padded to
             # 2,560, the root merge's
             (4, 300, 9984, 290, 9890, 256),
             # bands of 8,192: clusters of 16 blocks of 512 columns
             (2, 300, 16384, 297, 12000, 128),
             # bands of 20,480: clusters of 16 blocks of 1,280 columns,
             # 8 a thread
             (2, 64, 40960, 64, 40000, 64),
             # bands of 114,816 (padded to 129,024): the wave route, 7
             # clusters of 8 blocks a band, one launch of 64 rows, then a
             # full block of BLOCK_ROWS (both timed, beside the band cut
             # into sub-bands on the cluster route: MESH_SUB_BANDS)
             (2, 64, 229632, 64, 229000, 64),
             (2, 512, 229632, 512, 229000, 512)]
# the band kernel's instantiations by route: their names in KERNELS
MESH_ROUTES = {"cluster": "gotoh_mesh_cluster", "wave": "gotoh_mesh"}
# the simplest alternative to the wave route, timed beside it: each band
# cut into this many sub-bands of at most 114,688 columns, each on the
# cluster route, in order on its shard's stream
MESH_SUB_BANDS = 2
# mesh_procs: processes on the card, each with two shards
MESH_PROCS = 2
MESH_PROCS_TIMEOUT_S = 300
# the gpu-fast FASTA of each path run in this process (phase_path), and
# the gpu-mesh FASTA of each mesh path (phase_mesh_path)
FASTA = {}


def mesh_devices(n=None):
    """The mesh's devices: every visible card (cycled to n shards), or n
    (MESH_SHARDS) shards on cuda:0 on a one-card machine."""
    import torch
    cards = torch.cuda.device_count()
    n = n or (cards if cards > 1 else MESH_SHARDS)
    return [f"cuda:{i % cards}" for i in range(n)]


def mesh_of(n=None):
    from kalign_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(devices=mesh_devices(n))


def band_problem(rng, L1, W):
    """Random match scores and dyadic penalties of one L1 x W problem."""
    match = rng.standard_normal((L1, W), dtype=np.float32) * 3
    pc = (-rng.integers(16, 96, size=(3, W + 1)) / 32).astype(np.float32)
    pr = (-rng.integers(16, 96, size=(3, L1 + 1)) / 32).astype(np.float32)
    return match, pc, pr


def band_operands(mesh, match, pc, pr, la, lb, eps=1e-3):
    """gotoh_mesh.forward's inputs of one problem: W padded to a multiple
    of the shard count, the centering bias left to the kernel (slope lb /
    la, eps), each band on its shard."""
    import torch
    from kalign_tpu_torch.gpu import gotoh_mesh, gotoh_row
    from kalign_tpu_torch.parallel.mesh import put
    shards = mesh.shards
    L1, W = match.shape
    Wd = gotoh_mesh.band_width(W, len(shards), gotoh_mesh.alone(shards))
    Wp = Wd * len(shards)
    sh0 = shards[0]
    with gotoh_mesh.on(sh0):
        la_d, lb_d = (put(np.array([x], np.int32), sh0) for x in (la, lb))
        slope = lb_d.float() / torch.clamp(la_d.float(), min=1.0)
        prep = gotoh_row.prepare(
            put(np.pad(pc, ((0, 0), (0, Wp - W)))[None], sh0),
            put(pr[None], sh0), la_d, lb_d, slope,
            put(np.array([eps], np.float32), sh0))
    mp = np.pad(match, ((0, 0), (0, Wp - W)))
    bands = []
    for d, sh in enumerate(shards):
        with gotoh_mesh.on(sh):
            bands.append(put(mp[:, d * Wd:(d + 1) * Wd], sh))
    return bands, prep, Wp


def gathered(mesh, bands):
    """The bands' decisions side by side [L1p, n * Wd] on the first
    shard's card, for the checks (the engine walks each band on its own
    card), the card drained."""
    import torch
    torch.cuda.synchronize()
    dev = mesh.shards[0].device
    return torch.cat([b["dec"].to(dev) for b in bands], dim=1)


def band_run(mesh, bands, prep, Wp, la, lb, rows=None, plain=False):
    """gotoh_mesh.forward (kernel, or plain on the card), the decisions
    gathered: (dec [L1, Wp], score [1], state [1]), the card drained."""
    import torch
    from kalign_tpu_torch.gpu import gotoh_mesh
    bands, score, st = gotoh_mesh.forward(
        mesh.shards, bands, prep, la, lb,
        rows or gotoh_mesh.BLOCK_ROWS, use_plain=plain)
    dec = gathered(mesh, bands)
    torch.cuda.synchronize()
    return dec, score, st


def hold_band(what, got, want, la, lb, name="gotoh_mesh"):
    """Decisions equal on rows < la, columns < lb; score bitwise; state."""
    import torch
    (da, sa, sta), (db, sb, stb) = got, want
    diff = (da[:la, :lb].cpu() != db[:la, :lb].cpu()).nonzero()
    ok = (len(diff) == 0
          and torch.equal(sa.cpu().view(torch.int32),
                          sb.cpu().view(torch.int32))
          and torch.equal(sta.cpu(), stb.cpu()))
    if not ok:
        what += (f" ({len(diff)} decisions differ, the first at "
                 f"{diff[:3].tolist()}; scores {sa.tolist()} / "
                 f"{sb.tolist()}, end states {sta.tolist()} / "
                 f"{stb.tolist()})")
    hold(name, ok, abs_err(sa.cpu(), sb.cpu()), what)


def row_plain_of(match, pc, pr, la, lb, dev, eps=1e-3):
    """The unsplit row kernel's plain version on the card (any width)."""
    import torch
    from kalign_tpu_torch.gpu import gotoh_row
    t = lambda x, dt=np.float32: torch.from_numpy(
        np.asarray(x, dt)).to(dev)
    la_d, lb_d = t([la], np.int32), t([lb], np.int32)
    slope = lb_d.float() / torch.clamp(la_d.float(), min=1.0)
    d, s, st = gotoh_row.forward_plain(
        t(match[None]), t(pc[None]), t(pr[None]), la_d, lb_d, slope,
        t([eps]))
    return d[0], s, st


def phase_mesh_edge(dev):
    """The band kernel against its plain version on the card, bitwise
    (decisions in the valid region, score, end state), and both against
    the unsplit row DP's plain version: MESH_EDGE at 2, 3 and 4 shards
    (W a multiple of the shard count and not, bands padded to 128
    columns, L1 not a multiple of the block's rows, la < L1, lb inside
    the first band, la = 0, lb = 0, cluster-route cases and two
    wave-route cases, 64 rows and a full block) and the leading gap run
    of exactly one band (test_mesh_engine.py:114-150) at 2 and 4 shards,
    blocks of 5 rows.  Each case is held under its route's name
    (MESH_ROUTES).  Returns the wave route's timings by rows
    (band_timing, with the band cut into sub-bands beside it:
    sub_band_timing)."""
    import torch
    from kalign_tpu_torch.gpu import gotoh_mesh
    from kalign_tpu_torch.gpu import traceback as tb
    rng = np.random.default_rng(13)
    cases = [(n, L1, W, la, lb, rows, band_problem(rng, L1, W))
             for n, L1, W, la, lb, rows in MESH_EDGE]
    for n in (2, 4):
        Wd, la = 128, 24
        W = Wd * n
        match = np.full((la, W), -10.0, np.float32)
        for i in range(la):
            match[i, Wd + i] = 50.0
        pc = np.tile(np.array([[-8.0], [-4.0], [-0.5]], np.float32),
                     (1, W + 1))
        pr = np.tile(np.array([[-8.0], [-4.0], [-0.5]], np.float32),
                     (1, la + 1))
        cases.append((n, la, W, la, W, 5, (match, pc, pr)))
    before = read_counts()
    out, timed = [], {}
    for n, L1, W, la, lb, rows, (match, pc, pr) in cases:
        mesh = mesh_of(n)
        eps = 0.0 if rows == 5 else 1e-3
        ops = band_operands(mesh, match, pc, pr, la, lb, eps)
        cfg = gotoh_mesh.band_config(ops[2] // n,
                                     gotoh_mesh.alone(mesh.shards))
        name = MESH_ROUTES[cfg.route]
        got = band_run(mesh, *ops, la, lb, rows)
        what = (f"{n} shards {L1}x{W} la={la} lb={lb} rows={rows} "
                f"({cfg.route}, bands of {ops[2] // n})")
        plain, plain_ms = timed_once(
            lambda: band_run(mesh, *ops, la, lb, rows, plain=True))
        hold_band(what + " vs plain", got, plain, la, lb, name)
        hold_band(what + " vs the unsplit row DP", got,
                  row_plain_of(match, pc, pr, la, lb, dev, eps), la, lb,
                  name)
        if rows == 5:
            t = lambda x: torch.tensor([x], dtype=torch.int32, device=dev)
            steps, k = tb.walk_rows(got[0][None].contiguous(), t(la), t(lb),
                                    got[2].to(dev), L1 + W + 2)
            path = steps[0, :int(k[0])].tolist()
            Wd = W // n
            if path[:Wd] != [1] * Wd or path[Wd] != 0:
                raise AssertionError(f"{what}: the leading gap run is not "
                                     f"one band wide: {path[:Wd + 1]}")
        if cfg.route == "wave":
            timed[L1] = dict(band_timing(mesh, ops, la, lb, rows, plain_ms),
                             shape=what, sub_bands=sub_band_timing(
                                 mesh, (match, pc, pr), la, lb, rows, got))
        del ops, got, plain
        out.append(what)
    emit({"phase": "mesh_edge", "cases": out,
          "launches": {k: v - before[k] for k, v in read_counts().items()
                       if k in MESH_ROUTES.values()},
          "devices": mesh_devices(), "wave_route": timed})
    return timed


def sub_band_timing(mesh, problem, la, lb, rows, want):
    """The simplest alternative to the wave route on one problem (match,
    pc, pr): each band cut into MESH_SUB_BANDS sub-bands of at most
    114,688 columns, each on the cluster route, in order on its band's
    shard's stream (the row padded to that many sub-bands of the cluster
    route's widths); held bitwise against the wave route's result (want)
    and timed (mesh_device_ms)."""
    from types import SimpleNamespace
    from kalign_tpu_torch.gpu import gotoh_mesh
    shards = [sh for sh in mesh.shards for _ in range(MESH_SUB_BANDS)]
    alt = SimpleNamespace(shards=shards)
    sub, prep, Wp = band_operands(alt, *problem, la, lb)
    Ws = Wp // len(shards)
    cfg = gotoh_mesh.band_config(Ws, gotoh_mesh.alone(shards))
    if cfg.route != "cluster":
        raise AssertionError(f"sub-bands of {Ws} columns are not the "
                             "cluster route's")
    got = band_run(alt, sub, prep, Wp, la, lb, rows)
    hold_band(f"{mesh.size} shards {la}x{Wp} cut into {len(shards)} "
              "sub-bands vs the wave route", got, want, la, lb,
              "gotoh_mesh_cluster")
    d_ms, e_ms = mesh_device_ms(alt, lambda: gotoh_mesh.forward(
        shards, sub, prep, la, lb, rows))
    return dict(sub_bands=len(shards), band=Ws, route=cfg.route,
                cluster_blocks=cfg.blocks, threads=cfg.threads, ch=cfg.ch,
                device_ms=round(d_ms, 3), enqueue_ms=round(e_ms, 3))


def band_timing(mesh, ops, la, lb, rows, plain_ms):
    """A band case's main_shape entry: one call's wall (ms), the
    pipeline's device time and the host's enqueue time (mesh_device_ms),
    the plain version's wall, the bytes bound of its la x lb cells."""
    import torch
    from kalign_tpu_torch.gpu import gotoh_mesh
    bands, prep, Wp = ops
    _, ms = timed_once(lambda: band_run(mesh, *ops, la, lb, rows))
    dev_ms, enqueue_ms = mesh_device_ms(mesh, lambda: gotoh_mesh.forward(
        mesh.shards, bands, prep, la, lb, rows))
    t = lambda x: torch.tensor([x], dtype=torch.int32)
    b_ms, b_by = gotoh_bound(dict(la=t(la), lb=t(lb)), 1)
    cfg = gotoh_mesh.band_config(Wp // mesh.size,
                                 gotoh_mesh.alone(mesh.shards))
    with torch.cuda.device(mesh.shards[0].device):
        held = gotoh_mesh.max_active(cfg)
    return dict(ms=round(ms, 3), device_ms=round(dev_ms, 3),
                enqueue_ms=round(enqueue_ms, 3), plain_ms=round(plain_ms, 3),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                us_per_row=round(dev_ms * 1e3 / max(la, 1), 4),
                shards=mesh.size, cards=mesh.cards, rows_per_block=rows,
                launches_per_shard=-(-la // rows), plan=cfg._asdict(),
                max_active_clusters=held)


def align_on_mesh(seqs, mode, mesh):
    """(Msa, wall seconds) of one alignment on the engine gpu-mesh."""
    from kalign_tpu_torch.gpu.engine import GpuEngine
    return align_on_card(seqs, mode, GpuEngine(mesh=mesh))


@contextmanager
def recorded_long_merges(seen):
    """The arguments of each merge queued on parallel/mesh.py::LongQueue
    (its mesh first) appended to seen."""
    from kalign_tpu_torch.parallel import mesh as M
    orig = M.LongQueue.submit

    def rec(self, *args, **kw):
        if kw.get("what", "merge") == "merge":
            seen.append((self.mesh,) + args)
        return orig(self, *args, **kw)
    M.LongQueue.submit = rec
    try:
        yield
    finally:
        M.LongQueue.submit = orig


@contextmanager
def recorded_band_rows(rows):
    """The rows of every match block a band source of the column-sharded
    route made (parallel/mesh.py::band_source) appended to rows."""
    from kalign_tpu_torch.parallel import mesh as M
    orig = M.band_source

    def rec(*args, **kw):
        source = orig(*args, **kw)

        def counted(r0, r1, out=None):
            rows.append(r1 - r0)
            return source(r0, r1, out)
        return counted
    M.band_source = rec
    try:
        yield
    finally:
        M.band_source = orig


def wide_launches(st):
    """The launches of a run past 7,168 columns (engine_stats["batches"]):
    route, map DPs or merges, shape, problems a launch (on the batch axis
    their split over the shards), and how many such launches; raises
    where one holds a pad problem (la = lb = 8)."""
    from kalign_tpu_torch.gpu import gotoh_row
    out = {}
    for b in st["batches"]:
        if b["L2p"] <= gotoh_row.BAND_MAX:
            continue
        if np.any((b["la"] == 8) & (b["lb"] == 8)):
            raise AssertionError(f"a launch of {b['L1p']} x {b['L2p']} "
                                 "holds a pad problem")
        key = (f"{'maps' if b['maps'] else 'merges'} {b['route']} "
               f"{len(b['la'])}x{b['L1p']}x{b['L2p']}"
               + (f" over {b['shards']}" if "shards" in b else ""))
        out[key] = out.get(key, 0) + 1
    return out


def phase_mesh_path(name, seqs, mode="default"):
    """seqs on the engine gpu-mesh (mesh_devices() of the path's "shards",
    by default MESH_SHARDS on one card), in one run with every
    launch count set to 0 just before and read just after: the kernels of
    MESH_PATHS[name] launched, none it forbids; the same FASTA on one
    shard (unless the path skips it) and from gpu-fast (this run's path
    MESH_PATHS[name]["gpu_fast"], else aligned here); the launches past
    7,168 columns (wide_launches: no pad problem), the most rows a band's
    match block held (at most gotoh_mesh.FILL_BLOCKS blocks of
    gotoh_mesh.BLOCK_ROWS) and the peak device memory of the run.
    Returns (launches, stats, the long merges' arguments)."""
    import torch
    from kalign_tpu_torch.core import io as kio
    from kalign_tpu_torch.gpu import gotoh_mesh
    cfg = MESH_PATHS[name]
    mesh = mesh_of(cfg.get("shards"))
    seen, band_rows = [], []
    torch.cuda.empty_cache()
    for d in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(d)
    reset_counts()
    with recorded_long_merges(seen), recorded_band_rows(band_rows):
        msa, wall = align_on_mesh(seqs, mode, mesh)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    width = check_alignment(msa.aligned_rows(), seqs)
    fasta = FASTA[name] = kio.format_alignment(msa, "fasta")
    one = one_wall = None
    if cfg.get("one_shard", True):
        one, one_wall = align_on_mesh(seqs, mode, mesh_of(1))
    ref = cfg["gpu_fast"]
    if ref not in FASTA:
        FASTA[ref] = kio.format_alignment(align_on_card(seqs, mode)[0],
                                          "fasta")
    st = msa.engine_stats
    line = {"phase": "path", "path": name, "mode": mode,
            "sequences": len(seqs), "width": width,
            "engine": st["engine"], "shards": st["shards"],
            "cards": st["cards"], "tree": st["tree"],
            "long_merges": st["long_merges"], "row_merges": st["row_merges"],
            "long_maps": st["long_maps"],
            "walk_handoffs": st["walk_handoffs"],
            "dec_moved_bytes": st["dec_moved_bytes"],
            "card_peaks_gb": card_peaks_gb(),
            "map_pairs": st["map_pairs"],
            "one_shard_wall_s": None if one is None else round(one_wall, 3),
            "identical_fasta_one_shard": None if one is None else
                kio.format_alignment(one, "fasta") == fasta,
            "identical_fasta_gpu_fast": FASTA[ref] == fasta,
            "wide_launches": wide_launches(st),
            "band_block_rows_max": max(band_rows, default=0),
            "peak_memory_gb": round(peak / 1e9, 3),
            "launches": launches, **pass_summary(msa, wall)}
    emit(line)
    launch, forbid = cfg["launch"], cfg["forbid"]
    if gotoh_mesh.alone(mesh.shards):
        # bands on cards of their own take band_config's plan for their
        # width and card: either band kernel, not the shared cards' one
        bands = set(MESH_ROUTES.values())
        if bands & set(launch) and not any(launches[k] for k in bands):
            raise AssertionError(f"{name}: no band kernel launched")
        launch = [k for k in launch if k not in bands]
        forbid = [k for k in forbid if k not in bands]
    missing = [k for k in launch if launches[k] == 0]
    stray = [k for k in forbid if launches[k]]
    if missing or stray:
        raise AssertionError(f"{name}: kernels not launched {missing}, "
                             f"launched {stray}")
    if st["engine"] != "gpu-mesh" or st["shards"] != mesh.size:
        raise AssertionError(f"{name}: aligned on {st['engine']} over "
                             f"{st.get('shards')} shards")
    if line["band_block_rows_max"] > gotoh_mesh.FILL_BLOCKS * \
            gotoh_mesh.BLOCK_ROWS:
        raise AssertionError(f"{name}: a band's match block held "
                             f"{line['band_block_rows_max']} rows")
    if not (line["identical_fasta_one_shard"] in (None, True)
            and line["identical_fasta_gpu_fast"]):
        raise AssertionError(f"{name}: the mesh's FASTA is not the one "
                             "shard's and gpu-fast's")
    return launches, st, seen


def mesh_device_ms(mesh, run):
    """(device ms, the host's enqueue ms) of run(), work queued on the
    mesh's streams: every shard held behind a spin kernel on the first
    shard's stream (doubled until it outlasts the host's enqueueing),
    then joined back onto it; CUDA events around it there."""
    import torch
    from kalign_tpu_torch.gpu import gotoh_mesh
    shards = mesh.shards
    s0 = shards[0].stream
    cycles = 1 << 25
    for _ in range(8):
        spin, t0, t1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
        h0 = time.perf_counter()
        with torch.cuda.device(shards[0].device), torch.cuda.stream(s0):
            spin.record(s0)
            torch.cuda._sleep(cycles)
            t0.record(s0)
        for sh in shards[1:]:
            sh.stream.wait_event(t0)
        h1 = time.perf_counter()
        run()
        enqueue_ms = (time.perf_counter() - h1) * 1e3
        for sh in shards[1:]:
            s0.wait_event(gotoh_mesh.event(sh))
        t1.record(s0)
        host_ms = (time.perf_counter() - h0) * 1e3
        torch.cuda.synchronize()
        if spin.elapsed_time(t0) > host_ms:
            return t0.elapsed_time(t1), enqueue_ms
        cycles *= 2
    raise AssertionError("the spin kernel never outlasted the host's "
                         "enqueueing")


@contextmanager
def forced_plan(plan):
    """gotoh_mesh.band_config forced to plan(Wd) at every width, for an
    A/B of the routes on one merge."""
    from kalign_tpu_torch.gpu import gotoh_mesh
    orig = gotoh_mesh.band_config
    gotoh_mesh.band_config = plan
    try:
        yield
    finally:
        gotoh_mesh.band_config = orig


def cluster_plan(blocks, ch):
    """The cluster route with clusters of ``blocks`` and ch columns a
    thread at any width they cover exactly (with the strip ring)."""
    from kalign_tpu_torch.gpu import gotoh_mesh, gotoh_row

    def plan(Wd, alone=False):
        return gotoh_mesh.with_ring(
            gotoh_row.band_config(blocks, Wd // blocks, ch))
    return plan


def widest_merge(seen):
    """The mesh_long path's widest column-sharded merge (its root) rebuilt
    from its recorded arguments as LongQueue builds it: (the arguments,
    (each band's whole match, prep, Wp), its shape's name, the band
    sources LongQueue feeds the band kernel).  The whole bands, each
    made by its source in one block, let the kernel be timed alone."""
    from kalign_tpu_torch.parallel import mesh as M
    args = max(seen, key=lambda a: int(a[5]) * int(a[6]))
    mesh, lhs, rhs, pc, pr, la, lb, eps, bonus = args[:9]
    sources, prep, Wp = M.long_operands(mesh, lhs, rhs, pc, pr, la, lb, eps,
                                        bonus)
    whole = []
    for sh, src in zip(mesh.shards, sources):
        with M.on(sh):
            whole.append(src(0, lhs.shape[0]))
    return args, (whole, prep, Wp), (
        f"1x{lhs.shape[0]}x{rhs.shape[0]} la={la} lb={lb} over {mesh.size} "
        "shards"), sources


def band_device_ms(mesh, ops, la, lb, rows=None):
    """(device ms, the host's enqueue ms) of one gotoh_mesh.forward."""
    from kalign_tpu_torch.gpu import gotoh_mesh
    bands, prep, _ = ops
    return mesh_device_ms(mesh, lambda: gotoh_mesh.forward(
        mesh.shards, bands, prep, la, lb, rows or gotoh_mesh.BLOCK_ROWS))


def mesh_root_merge(dev, seen):
    """The mesh_long path's root merge (widest_merge): the band kernel
    held against its plain version on the card and against the cluster
    row kernel on the same match (the bands gathered; dec in the valid
    region, score, end state); the pipeline's wall, device time and host
    enqueue time (mesh_device_ms), the cluster row kernel's device time
    on that match (device_ms) and the bytes bound (a match read and a
    decision written per cell); the pipeline fed its band sources (each
    band's match a block of rows at a time, as LongQueue runs it) held
    against it fed the whole bands, and its device and enqueue times
    beside.  Returns the main_shape entry of the route taken."""
    import torch
    from kalign_tpu_torch.gpu import gotoh_row
    from kalign_tpu_torch.parallel import mesh as M
    G = M.gotoh_mesh
    args, ops, shape, sources = widest_merge(seen)
    mesh, _, rhs, pc, pr, la, lb, eps, bonus = args[:9]
    bands, prep, Wp = ops
    L2p = rhs.shape[0]
    cfg = G.band_config(Wp // mesh.size, G.alone(mesh.shards))
    name = MESH_ROUTES[cfg.route]
    got, ms = timed_once(lambda: band_run(mesh, *ops, la, lb))
    plain, plain_ms = timed_once(
        lambda: band_run(mesh, *ops, la, lb, plain=True))
    hold_band(shape + " vs plain", got, plain, la, lb, name)
    src_ops = (sources, prep, Wp)
    fed, fed_ms = timed_once(lambda: band_run(mesh, *src_ops, la, lb))
    hold_band(shape + " fed its band sources vs whole bands", fed, got, la,
              lb, name)
    src_ms, src_enqueue_ms = band_device_ms(mesh, src_ops, la, lb)
    # the same match on one card, through the cluster row kernel
    full = torch.cat([b.to(dev) for b in bands], dim=1)[None, :, :L2p]
    full = full.contiguous()
    t = lambda x, dt: torch.from_numpy(np.asarray(x, dt)).to(dev)
    la_d, lb_d = t([la], np.int32), t([lb], np.int32)
    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    if bonus is None:
        slope = lb_d.float() / torch.clamp(la_d.float(), min=1.0)
        e = t([eps], np.float32)
    else:
        slope, e = zero, zero
    prep1 = gotoh_row.prepare(t(pc[None], np.float32),
                              t(pr[None], np.float32), la_d, lb_d, slope, e)
    row_cfg = gotoh_row.launch_config(1, L2p)
    cluster = gotoh_row.launch(full, prep1, la_d, lb_d)
    hold_band(shape + " vs the cluster row kernel", got,
              (cluster[0][0], cluster[1], cluster[2]), la, lb, name)
    dev_ms, enqueue_ms = band_device_ms(mesh, ops, la, lb)
    cluster_ms = device_ms(lambda: gotoh_row.launch(full, prep1, la_d, lb_d),
                           reps=3)
    b_ms, b_by = gotoh_bound(dict(la=la_d, lb=lb_d), 1)
    common = dict(shape=shape, plain_ms=round(plain_ms, 3), bound_ms=b_ms,
                  bound_by=b_by, library_ms=None, shards=mesh.size,
                  cards=mesh.cards, band=Wp // mesh.size,
                  rows_per_block=G.BLOCK_ROWS,
                  launches_per_shard=-(-la // G.BLOCK_ROWS))
    out = dict(ms=round(ms, 3), device_ms=round(dev_ms, 3),
               enqueue_ms=round(enqueue_ms, 3), **common,
               route=cfg.route, ch=cfg.ch, threads=cfg.threads,
               cluster_blocks=cfg.blocks,
               sources_ms=round(fed_ms, 3),
               sources_device_ms=round(src_ms, 3),
               sources_enqueue_ms=round(src_enqueue_ms, 3),
               cluster_device_ms=round(cluster_ms, 3),
               cluster_plan=row_cfg._asdict())
    emit({"phase": "main_shape", "kernel": name, **out})
    return out


def wide_merge(dev, seen):
    """The mesh_wide path's widest column-sharded merge (its recorded
    merge arguments: the most columns, then rows) as LongQueue runs
    it on the path's two shards of one card (the memory guard,
    long_operands' band sources, the band pipeline on the wave route, the
    decisions gathered for the check), against the same merge on one card
    through the row kernel's wave route (gotoh_wave.forward_operands,
    itself bitwise to the unsplit row DP): decisions in the valid region,
    score bits and end state equal.  Its rows, columns, bands, launches of the band
    kernel's wave route, wall and peak device memory of each side."""
    import torch
    from kalign_tpu_torch.gpu import gotoh_wave
    from kalign_tpu_torch.parallel import mesh as M
    G = M.gotoh_mesh
    args = max(seen, key=lambda a: (a[2].shape[0], a[1].shape[0]))
    mesh, lhs, rhs, pc, pr, la, lb, eps, bonus = args[:9]
    L1p, L2p = lhs.shape[0], rhs.shape[0]
    shape = f"1x{L1p}x{L2p} la={la} lb={lb} over {mesh.size} shards"

    def on_mesh():
        M.check_long_fits(mesh, L1p, L2p)
        sources, prep, Wp = M.long_operands(mesh, lhs, rhs, pc, pr, la, lb,
                                            eps, bonus)
        bands, score, st = G.forward(mesh.shards, sources, prep, la, lb)
        return gathered(mesh, bands), score, st, Wp

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = G.launches
    (dec, score, st, Wp), mesh_ms = timed_once(on_mesh)
    launches = G.launches - before
    mesh_peak = torch.cuda.max_memory_allocated()
    got = (dec.cpu(), score.cpu(), st.cpu())
    del dec
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    one = [t(np.array([x], dt)) for x, dt in ((la, np.int32),
                                              (lb, np.int32),
                                              (eps, np.float32))]
    b1 = None if bonus is None else (
        torch.tensor(np.float32(bonus[0])).to(dev),
        *(t(v[None]) for v in bonus[1:]))
    (wd, ws, wst), wave_ms = timed_once(lambda: gotoh_wave.forward_operands(
        t(lhs[None]), t(rhs[None]), t(pc[None]), t(pr[None]), *one, b1,
        la_h=[la]))
    wave_peak = torch.cuda.max_memory_allocated()
    hold_band(shape + " vs the same merge on one card's wave route", got,
              (wd[0].cpu(), ws.cpu(), wst.cpu()), la, lb, "gotoh_mesh")
    del wd
    torch.cuda.empty_cache()
    cfg = G.band_config(Wp // mesh.size, G.alone(mesh.shards))
    out = dict(shape=shape, rows=L1p, columns=L2p, la=la, lb=lb,
               bonus=bonus is not None, bands=mesh.size,
               band=Wp // mesh.size, route=cfg.route,
               clusters=getattr(cfg, "bands", 1),
               launches=launches, mesh_ms=round(mesh_ms, 3),
               mesh_peak_gb=round(mesh_peak / 1e9, 3),
               wave_ms=round(wave_ms, 3),
               wave_peak_gb=round(wave_peak / 1e9, 3),
               cards=mesh.cards)
    emit({"phase": "whole_merge", **out})
    if cfg.route != "wave" or launches == 0:
        raise AssertionError(f"{shape}: not on the band kernel's wave route")
    return out


# the sweeps that chose band_config and BLOCK_ROWS (--only mesh_sweep):
# rows a block (the pipeline's fill is (shards - 1) blocks; each launch
# costs the host an enqueue), and cluster plans (blocks, columns a thread)
# at the root merge's bands of 2,560 columns and at bands of SWEEP_WIDTH
BLOCK_ROWS_SWEEP = (256, 512, 1024)
WAVE_ROWS_SWEEP = (256, 512, 1024, 2048)
CLUSTER_SWEEP = {2560: ((1, 8), (2, 4), (4, 4), (5, 4), (10, 4)),
                 8192: ((2, 8), (4, 8), (8, 4), (16, 4))}
SWEEP_ROWS, SWEEP_SHARDS = 2048, 2


def sweep_band(mesh, ops, la, lb, shape):
    """Device ms (and the host's enqueue ms) of the band pipeline on one
    problem under band_config's plan at each of BLOCK_ROWS_SWEEP and under
    each CLUSTER_SWEEP plan of its band width at BLOCK_ROWS, each forced
    plan held bitwise against band_config's."""
    from kalign_tpu_torch.gpu import gotoh_mesh
    Wd = ops[2] // mesh.size
    cfg = gotoh_mesh.band_config(Wd, gotoh_mesh.alone(mesh.shards))
    got = band_run(mesh, *ops, la, lb)
    rows = {}
    for r in BLOCK_ROWS_SWEEP:
        d_ms, e_ms = band_device_ms(mesh, ops, la, lb, r)
        rows[r] = dict(device_ms=round(d_ms, 3), enqueue_ms=round(e_ms, 3),
                       launches_per_shard=-(-la // r))
    plans = {}
    for blocks, ch in CLUSTER_SWEEP[Wd]:
        with forced_plan(cluster_plan(blocks, ch)):
            other = band_run(mesh, *ops, la, lb)
            d_ms, _ = band_device_ms(mesh, ops, la, lb)
        hold_band(f"{shape} under clusters of {blocks} x {ch}", other, got,
                  la, lb, "gotoh_mesh_cluster")
        plans[f"{blocks}x{Wd // blocks}x{ch}"] = round(d_ms, 3)
    out = dict(shape=shape, band=Wd, plan=cfg._asdict(), rows_sweep=rows,
               cluster_sweep_device_ms=plans)
    emit({"phase": "mesh_sweep", **out})
    return out


def sweep_wave_rows(seen):
    """Rows a launch on the band kernel's wave route (WAVE_ROWS_SWEEP): the
    mesh_wide path's widest merge (wide_merge's) fed its band sources as
    LongQueue feeds them, the band pipeline's device and enqueue ms at
    each, each held bitwise against BLOCK_ROWS'."""
    from kalign_tpu_torch.parallel import mesh as M
    G = M.gotoh_mesh
    args = max(seen, key=lambda a: (a[2].shape[0], a[1].shape[0]))
    mesh, lhs, rhs, pc, pr, la, lb, eps, bonus = args[:9]
    ops = M.long_operands(mesh, lhs, rhs, pc, pr, la, lb, eps, bonus)
    shape = (f"1x{lhs.shape[0]}x{rhs.shape[0]} la={la} lb={lb} over "
             f"{mesh.size} shards")
    want = band_run(mesh, *ops, la, lb, G.BLOCK_ROWS)
    want = tuple(x.cpu() for x in want)
    rows = {}
    for r in WAVE_ROWS_SWEEP:
        hold_band(f"{shape} at {r} rows a launch", tuple(
            x.cpu() for x in band_run(mesh, *ops, la, lb, r)), want, la, lb,
            "gotoh_mesh")
        d_ms, e_ms = band_device_ms(mesh, ops, la, lb, r)
        rows[r] = dict(device_ms=round(d_ms, 3), enqueue_ms=round(e_ms, 3),
                       us_per_row=round(d_ms * 1e3 / la, 4),
                       launches_per_shard=-(-la // r))
    out = dict(shape=shape, band=ops[2] // mesh.size,
               plan=G.band_config(ops[2] // mesh.size,
                                  G.alone(mesh.shards))._asdict(),
               wave_rows_sweep=rows)
    emit({"phase": "mesh_sweep", **out})
    return out


def phase_mesh_sweep(seen, wide_seen):
    """sweep_band at the mesh_long root merge (widest_merge) and on a
    random SWEEP_ROWS-row problem of SWEEP_SHARDS bands of 8,192 columns
    (the second width of CLUSTER_SWEEP); sweep_wave_rows at the mesh_wide
    path's widest merge."""
    sweep_wave_rows(wide_seen)
    args, ops, shape, _ = widest_merge(seen)
    sweep_band(args[0], ops, args[5], args[6], shape)
    mesh = mesh_of(SWEEP_SHARDS)
    W = 8192 * SWEEP_SHARDS
    match, pc, pr = band_problem(np.random.default_rng(17), SWEEP_ROWS, W)
    ops = band_operands(mesh, match, pc, pr, SWEEP_ROWS, W)
    sweep_band(mesh, ops, SWEEP_ROWS, W,
               f"1x{SWEEP_ROWS}x{W} over {SWEEP_SHARDS} shards")


def profile_mesh_host(top=30):
    """The host side of the mesh_long path (the long genomes on gpu-mesh,
    default mode) under cProfile, after a warm-up on 8 of them: the
    wall, the progressive pass's host split and the functions that took
    the most host time (their own, tottime, and with their callees,
    cumtime).  cProfile slows the Python side, so the wall is longer
    than an unprofiled run's."""
    import cProfile
    import pstats
    seqs = long_genomes()
    mesh = mesh_of()
    align_on_mesh(seqs[:8], "default", mesh)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    msa, _ = align_on_mesh(seqs, "default", mesh)
    prof.disable()
    wall = time.perf_counter() - t0
    rows = []
    for (path, line, fn), (_, nc, tt, ct, _) in \
            pstats.Stats(prof).stats.items():
        rows.append(dict(fn=f"{os.path.relpath(path, HERE)}:{line}:{fn}"
                         if path.startswith(HERE) else f"{path}:{fn}",
                         calls=nc, tottime=round(tt, 3),
                         cumtime=round(ct, 3)))
    es = msa.engine_stats
    emit({"phase": "profile_host", "path": "mesh_long",
          "sequences": len(seqs), "wall_s": wall, "shards": mesh.size,
          "cards": mesh.cards,
          **{k: es.get(k) for k in ("engine", "long_merges", "row_merges",
                                    "progressive_split_s")},
          "by_tottime": sorted(rows, key=lambda r: -r["tottime"])[:top],
          "by_cumtime": sorted(rows, key=lambda r: -r["cumtime"])[:top]})


def rendezvous(rank, nproc, path):
    """(coordinator address, store) of mesh_proc's group: process 0 starts
    the store's server on a port the kernel assigns and publishes the
    port in the file ``path`` (init_process_group's tcp rendezvous joins
    that server, multi-tenant); the others wait for the file.  No port is
    chosen, closed and bound again, so none can be lost to another
    process meanwhile.  Process 0 keeps the store until it leaves."""
    from datetime import timedelta
    import torch.distributed as dist
    store = None
    if rank == 0:
        store = dist.TCPStore("127.0.0.1", 0, nproc, True,
                              timedelta(seconds=MESH_PROCS_TIMEOUT_S),
                              wait_for_workers=False, multi_tenant=True)
        with open(path + ".tmp", "w") as fh:
            fh.write(str(store.port))
        os.replace(path + ".tmp", path)
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > MESH_PROCS_TIMEOUT_S:
            raise TimeoutError(f"process {rank}: no coordinator port")
        time.sleep(0.05)
    with open(path) as fh:
        return "127.0.0.1:" + fh.read(), store


def wide_bucket(L1p=128, L2p=7424):
    """One merge too wide for the register row kernel (host arrays of
    dispatch_bucket): the column-sharded route on a mesh of shards."""
    return (np.zeros((1, L1p, 23), np.float32),
            np.zeros((1, L2p, 23), np.float32),
            np.zeros((1, 3, L2p + 1), np.float32),
            np.zeros((1, 3, L1p + 1), np.float32),
            np.array([L1p], np.int32), np.array([L2p - 100], np.int32),
            np.array([1e-3], np.float32))


def mesh_proc_path(rank, device, work):
    """mesh_proc's alignment: the mesh_default family (2,000 proteins,
    default mode) on the engine gpu-mesh over the processes' mesh (two
    shards of ``device`` each), every launch count set to 0 just before
    and read just after; engine "auto" must take gpu-mesh under the group
    (F7), and the column-sharded DP and the engine's route to it must
    raise across processes.  Writes the FASTA and a summary (launches,
    pass_summary, buckets, gathers) into work."""
    from kalign_tpu_torch import engine as TE
    from kalign_tpu_torch.core import io as kio
    from kalign_tpu_torch.core.msa import Msa
    from kalign_tpu_torch.parallel import mesh as M
    seqs = family(2000, seed=0)
    auto = TE.resolve_auto_engine(Msa.from_sequences(seqs))
    if auto != "gpu-mesh":
        raise AssertionError(f"process {rank}: auto took {auto}")
    mesh = M.make_mesh(devices=[device] * 2)
    eng = TE.get_engine("gpu-mesh", mesh=mesh)
    reset_counts()
    msa, wall = align_on_card(seqs, "default", eng)
    launches = read_counts()
    check_alignment(msa.aligned_rows(), seqs)
    st = msa.engine_stats
    raised = []
    for what, run in (
            ("sharded_long_gotoh", lambda: M.sharded_long_gotoh(
                mesh, np.zeros((4, 4), np.float32),
                np.zeros((3, 5), np.float32), np.zeros((3, 5), np.float32),
                4, 4)),
            ("dispatch_bucket", lambda: eng.dispatch_bucket(
                *wide_bucket()))):
        try:
            run()
        except ValueError as e:
            named = "one process" in str(e) and (
                what == "sharded_long_gotoh" or "7424" in str(e))
            raised.append(what if named else str(e))
    if raised != ["sharded_long_gotoh", "dispatch_bucket"]:
        raise AssertionError(f"process {rank}: the column-sharded route "
                             f"across processes: {raised}")
    with open(os.path.join(work, f"mesh{rank}.afa"), "w") as fh:
        fh.write(kio.format_alignment(msa, "fasta"))
    with open(os.path.join(work, f"mesh{rank}.json"), "w") as fh:
        json.dump({"launches": launches, "auto": auto,
                   "shards": st["shards"], "cards": st["cards"],
                   "processes": st["processes"],
                   "local_shards": st["local_shards"],
                   "buckets": sum("shards" in b for b in st["batches"]),
                   "gathers": {"calls": st["gathers"]["calls"],
                               "s": round(st["gathers"]["s"], 3)},
                   **pass_summary(msa, wall)}, fh)


def mesh_proc(rank, nproc, rdv, work, device):
    """One process of phase_mesh_procs (spawned): joins the gloo group
    (rendezvous), runs mesh_case on its two shards of the processes'
    mesh (rank 0 saves the result), aligns the mesh_default family on
    gpu-mesh over that mesh (mesh_proc_path), then its my_ensemble_runs
    share of small.fa's 3-run ensemble into work/scratch (the CLI's
    worker step); it leaves through a barrier."""
    import torch.distributed as dist
    from kalign_tpu_torch import cli
    from kalign_tpu_torch.parallel.distributed import init_distributed, \
        my_ensemble_runs
    from kalign_tpu_torch.parallel.mesh import make_mesh
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    coord, store = rendezvous(rank, nproc, rdv)
    init_distributed(coord, nproc, rank)
    mesh = make_mesh(devices=[device] * 2)
    if mesh.size != 2 * nproc or not mesh.spans_processes:
        raise AssertionError(f"process {rank}: a mesh of {mesh.size}")
    dm, steps, scores = mesh_case(mesh)
    if rank == 0:
        np.savez(os.path.join(work, "procs.npz"), dm=dm, scores=scores,
                 **{f"steps{i}": s for i, s in enumerate(steps)})
    mesh_proc_path(rank, device, work)
    # the CLI's worker step aligns the runs k % workers == worker
    if my_ensemble_runs(3) != [k for k in range(3) if k % nproc == rank]:
        raise AssertionError(f"process {rank}: runs {my_ensemble_runs(3)}")
    rc = cli.main(["-i", os.path.join(HERE, "tests", "data", "small.fa"),
                   "-o", os.path.join(work, f"w{rank}.afa"), "--ensemble",
                   "3", "--ensemble-scratch", os.path.join(work, "scratch"),
                   "--ensemble-worker", str(rank), "--ensemble-workers",
                   str(nproc), "--device", device, "--quiet"])
    dist.barrier()
    dist.destroy_process_group()
    del store
    if rc:
        raise AssertionError(f"process {rank}: the worker step returned {rc}")


def mesh_case(mesh):
    """The mesh's sharded anchor distances of the protein family (its
    first 1,000 sequences, encoded and sorted as align_msa does, against
    its anchors) and one sharded merge bucket of 8 random 128 x 128
    problems (test_distributed.py:139-190's case)."""
    from kalign_tpu_torch import engine as TE
    from kalign_tpu_torch.core import alphabet as alpha
    from kalign_tpu_torch.core.msa import Msa
    from kalign_tpu_torch.gpu.distances import token_table
    from kalign_tpu_torch.parallel import mesh as M
    msa = Msa.from_sequences(family(1000, seed=0))
    msa.quiet = True
    msa.sort_len_name()
    codes = TE._encoded(msa, alpha.ALPHA_REDUCED_PROTEIN)
    toks, lens = token_table(codes)
    dm = M.sharded_anchor_distances(mesh, toks, lens, TE.pick_anchors(msa))
    rng = np.random.default_rng(0)
    B, L = 8, 128
    lhs = rng.normal(size=(B, L, 23)).astype(np.float32)
    rhs = rng.normal(size=(B, L, 23)).astype(np.float32)
    pens = np.tile(np.array([-7.0, -1.25, -1.0], np.float32)[None, :, None],
                   (B, 1, L + 1))
    la = np.full(B, L - 5, np.int32)
    lb = np.full(B, L - 3, np.int32)
    eps = np.full(B, 1e-3, np.float32)
    steps, scores = M.sharded_bucket_step(mesh, lhs, rhs, pens, pens, la, lb,
                                          eps)
    return dm, steps, scores


def phase_mesh_procs(device="cuda:0"):
    """MESH_PROCS processes on the card under init_distributed, each with
    two shards of one mesh: their sharded distances and bucket must equal
    this process's on a mesh of as many shards; each aligns the
    mesh_default family on gpu-mesh over that mesh (mesh_proc_path),
    and its FASTA must be gpu-fast's (and so mesh_default's, where that
    path ran here); every kernel of MESH_PATHS["mesh_default"] launched
    in each process, none it forbids; the 3-run ensemble of small.fa
    split by my_ensemble_runs, then merged, must give the sequential
    `--ensemble 3` bytes (the CLI's).  The processes' shards are on
    ``device``.  A process that fails fails the phase; nothing is run
    again.  Returns the path's launches, summed over the processes."""
    import multiprocessing
    import shutil
    import tempfile
    from kalign_tpu_torch import cli
    from kalign_tpu_torch.core import io as kio
    work = tempfile.mkdtemp(prefix="ktm")
    try:
        ctx = multiprocessing.get_context("spawn")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=mesh_proc, args=(
            r, MESH_PROCS, os.path.join(work, "port"), work, device))
            for r in range(MESH_PROCS)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(MESH_PROCS_TIMEOUT_S)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        procs_s = time.perf_counter() - t0
        codes = [p.exitcode for p in procs]
        if codes != [0] * MESH_PROCS:
            raise AssertionError(f"mesh_procs: exit codes {codes}")
        got = np.load(os.path.join(work, "procs.npz"))
        dm, steps, scores = mesh_case(mesh_of(2 * MESH_PROCS))
        same = (np.array_equal(got["dm"], dm)
                and np.array_equal(got["scores"], scores)
                and all(np.array_equal(got[f"steps{i}"], s)
                        for i, s in enumerate(steps)))
        if "protein_default" not in FASTA:
            FASTA["protein_default"] = kio.format_alignment(
                align_on_card(family(2000, seed=0), "default")[0], "fasta")
        path, fastas = {}, []
        for r in range(MESH_PROCS):
            with open(os.path.join(work, f"mesh{r}.json")) as fh:
                path[r] = json.load(fh)
            with open(os.path.join(work, f"mesh{r}.afa")) as fh:
                fastas.append(fh.read())
        small = os.path.join(HERE, "tests", "data", "small.fa")
        outs = {}
        for kind, extra in (("merged", ["--ensemble-scratch",
                                        os.path.join(work, "scratch"),
                                        "--ensemble-merge"]),
                            ("sequential", [])):
            outs[kind] = os.path.join(work, kind + ".afa")
            rc = cli.main(["-i", small, "-o", outs[kind], "--ensemble", "3",
                           "--device", device, "--quiet", *extra])
            if rc:
                raise AssertionError(f"mesh_procs: the {kind} CLI call "
                                     f"returned {rc}")
        with open(outs["merged"]) as a, open(outs["sequential"]) as b:
            ens_same = a.read() == b.read()
        cfg = MESH_PATHS["mesh_default"]
        launches = {k: sum(path[r]["launches"][k] for r in path)
                    for k in path[0]["launches"]}
        missing = {r: [k for k in cfg["launch"] if not p["launches"][k]]
                   for r, p in path.items()}
        stray = [k for k in cfg["forbid"] if launches[k]]
        emit({"phase": "mesh_procs", "processes": MESH_PROCS,
              "shards": 2 * MESH_PROCS, "procs_s": round(procs_s, 3),
              "identical_distances_and_bucket": same,
              "identical_ensemble_fasta": ens_same,
              "identical_fasta_gpu_fast": [f == FASTA["protein_default"]
                                           for f in fastas],
              "identical_fasta_mesh_default": None
              if "mesh_default" not in FASTA else
              [f == FASTA["mesh_default"] for f in fastas],
              "path": {r: {k: v for k, v in p.items() if k != "launches"}
                       for r, p in path.items()},
              "launches": launches})
        if not (same and ens_same):
            raise AssertionError("mesh_procs: the processes' results differ "
                                 "from one process's")
        if any(f != FASTA["protein_default"] for f in fastas):
            raise AssertionError("mesh_procs: a process's gpu-mesh FASTA is "
                                 "not gpu-fast's")
        if any(missing.values()) or stray:
            raise AssertionError(f"mesh_procs: kernels not launched "
                                 f"{missing}, launched {stray}")
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_wave_edge(dev):
    """The wave route's and the match preparation's edge cases alone
    (edge_cases_wave on phase_edge_cases' 64 x 384 x 384 problem,
    edge_cases_prepare)."""
    from kalign_tpu_torch.gpu import gotoh_row
    rng = np.random.default_rng(0)
    la = rng.integers(1, 385, size=64)
    lb = rng.integers(1, 385, size=64)
    la[[0, 2]] = 0
    lb[[1, 2]] = 0
    lb[3] = 384
    p = dp_problem(rng, 384, 384, la, lb, dev)
    edge_cases_wave(dev, rng, p, gotoh_row.forward_plain(*dp_args(p)))
    edge_cases_prepare(dev, rng)
    emit({"phase": "wave_edge", "ok": True})


def large_family():
    """The large_default path's input: 16,384 protein sequences."""
    return family(16384, seed=4)


def card_peaks_gb():
    """torch.cuda.max_memory_allocated of every visible card, GB."""
    import torch
    return [round(torch.cuda.max_memory_allocated(d) / 1e9, 3)
            for d in range(torch.cuda.device_count())]


# the walk over a column-sharded DP's bands (walk_bands, each band's walk
# on its card, csrc/traceback.cu from a cell to the band's left edge):
# (bands, L1, band width, la, lb, p_diag, p_ext) of random decisions
MESH_WALKS = [(2, 300, 256, 300, 512, 0.9, 0.3),
              (3, 700, 512, 650, 1400, 0.7, 0.6),   # lb past the pads
              (4, 1000, 1024, 999, 3800, 0.95, 0.2),
              (4, 400, 128, 400, 300, 0.5, 0.8),    # lb in band 2
              (4, 2000, 128, 10, 500, 0.9, 0.3),    # row 0 across bands
              (2, 64, 4096, 60, 8000, 0.8, 0.5)]


def phase_mesh_walk(dev):
    """walk_bands on the mesh's shards (every card, or MESH_SHARDS on
    cuda:0) against the walk over the bands gathered (traceback.walk_rows
    on the first card, the walk kernel's whole-matrix form) and against
    the plain walk whose fetch reads the band holding each column, bitwise
    (steps and counts), from random end states: MESH_WALKS of random
    decisions, and three column-sharded DPs from band_operands (bands of
    their kernel, the walk starting past the pad columns)."""
    import torch
    from kalign_tpu_torch.gpu import gotoh_mesh
    from kalign_tpu_torch.gpu import traceback as tb
    from kalign_tpu_torch.parallel import mesh as M
    rng = np.random.default_rng(29)
    out = []

    def hold_case(mesh, bands, la, lb, st, what):
        Wd = bands[0]["dec"].shape[1]
        n = len(bands)
        ms = bands[0]["dec"].shape[0] + n * Wd + 2
        got, crossed, _ = M.walk_bands(mesh, bands, la, lb,
                                       torch.tensor([st], dtype=torch.int32),
                                       ms)
        full = gathered(mesh, bands)[None]
        t = lambda x: torch.tensor([x], dtype=torch.int32, device=dev)
        s, k = tb.walk_rows(full, t(la), t(lb), t(st), ms)
        whole = s[0, :int(k[0])].cpu().numpy()
        host = [b["dec"].cpu() for b in bands]

        def fetch(r, c):
            d = torch.clamp(c // Wd, max=n - 1)
            return torch.stack([host[int(x)][int(rr), int(cc) - int(x) * Wd]
                                for x, rr, cc in zip(d, r, c)]).to(
                torch.int64) & 0xFF
        ps, pk = tb.plain(fetch, torch.tensor([la]), torch.tensor([lb]),
                          torch.tensor([st]), ms)
        plain = ps[0, :int(pk[0])].numpy()
        ok = np.array_equal(got, whole) and np.array_equal(got, plain)
        hold("traceback", ok, 0.0 if ok else 1.0,
             f"walk_bands {what} vs the gathered walk and the plain walk")
        out.append(dict(case=what, steps=len(got), crossings=crossed))

    mesh = mesh_of()
    for n, L1, Wd, la, lb, p_diag, p_ext in MESH_WALKS:
        m = mesh_of(n)
        dec = walk_decisions(rng, 1, L1, n * Wd, p_diag, p_ext)[0]
        bands = []
        for d, sh in enumerate(m.shards):
            with gotoh_mesh.on(sh):
                bands.append({"dec": torch.from_numpy(np.ascontiguousarray(
                    dec[:, d * Wd:(d + 1) * Wd])).to(sh.device)})
        hold_case(m, bands, la, lb, int(rng.integers(0, 3)),
                  f"{n} x {L1} x {Wd} la={la} lb={lb}")
    for n, L1, W, la, lb in ((2, 700, 3000, 690, 2900),
                             (4, 600, 9984, 580, 9890),
                             (len(mesh.shards), 900, 20000, 900, 19000)):
        m = mesh_of(n)
        match, pc, pr = band_problem(rng, L1, W)
        ops = band_operands(m, match, pc, pr, la, lb)
        bands, score, st = gotoh_mesh.forward(m.shards, *ops[:2], la, lb)
        torch.cuda.synchronize()
        hold_case(m, bands, la, lb, int(st.cpu()[0]),
                  f"a DP of {L1} x {W} over {n} bands, la={la} lb={lb}")
    emit({"phase": "mesh_walk", "cases": out, "cards": mesh.cards})


# the sweep that set gotoh_mesh.ALONE_WAVE_MIN (--only mesh_sweep or
# mesh_sweep:alone): one band on a card of its own,
# SWEEP_ALONE_ROWS rows, at each width the cluster plan (band_config's on
# shared cards) and the wave plan over up to each of SWEEP_ALONE_BANDS
# clusters, device time a row, each plan held bitwise against the plain
# version
SWEEP_ALONE_WIDTHS = (8192, 16384, 24576, 32768, 49152, 61440, 73856,
                      98304, 114688)
SWEEP_ALONE_BANDS = (7, 11, 15)
SWEEP_ALONE_ROWS = 2048


def sweep_alone():
    from kalign_tpu_torch.gpu import gotoh_mesh, gotoh_row
    from kalign_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(devices=["cuda:0"])
    rng = np.random.default_rng(31)
    R = SWEEP_ALONE_ROWS
    rows = []
    for W in SWEEP_ALONE_WIDTHS:
        match, pc, pr = band_problem(rng, R, W)
        shared = gotoh_mesh.band_config(W)
        plans = {f"cluster {shared.blocks}x{shared.band}": shared}
        for k in SWEEP_ALONE_BANDS:
            cfg = gotoh_row.wave_config(W, k)
            plans[f"wave {cfg.bands}x{cfg.blocks}x{cfg.band}"] = cfg
        want = None
        times = {}
        for name, cfg in plans.items():
            with forced_plan(lambda Wd, alone=False, c=cfg: c):
                ops = band_operands(mesh, match, pc, pr, R, W)
                got = band_run(mesh, *ops, R, W)
                if want is None:
                    want = band_run(mesh, *ops, R, W, plain=True)
                    want = tuple(x.cpu() for x in want)
                d_ms, _ = band_device_ms(mesh, ops, R, W)
            hold_band(f"1 x {R} x {W} alone on its card, {name}",
                      tuple(x.cpu() for x in got), want, R, W,
                      MESH_ROUTES[cfg.route])
            times[name] = round(d_ms * 1e3 / R, 4)
        best = min(times, key=times.get)
        chosen = gotoh_mesh.band_config(W, True)
        rows.append(dict(width=W, us_per_row=times, fastest=best,
                         band_config_alone=f"{chosen.route} "
                         f"{getattr(chosen, 'bands', 1)}x{chosen.blocks}x"
                         f"{chosen.band}"))
        emit({"phase": "mesh_sweep", "alone": rows[-1]})
    return rows


# mesh_pairs: map DPs of MESH_PAIRS hcmv_genomes pairs
MESH_PAIRS = 2


def phase_mesh_pairs():
    """Consistency-map DPs of MESH_PAIRS pairs of ~236 kb genomes
    (hcmv_genomes) called directly through GpuEngine.dp_leaf_batch: on
    one card's wave route (GpuEngine("cuda:0"); one card holds them) and
    through the column-sharded route over every card (a mesh engine,
    map_sharded forced): the step lists that reach the maps equal, pad
    for pad; the maps equal; walls, the walk's band crossings, each
    card's peak."""
    import torch
    from types import SimpleNamespace
    from kalign_tpu_torch.gpu import engine as E
    seqs = hcmv_genomes()
    table = np.zeros(256, np.uint8)
    for i, c in enumerate(DNA):
        table[ord(c)] = i
    codes = [table[np.frombuffer(x.encode(), np.uint8)] for x in seqs]
    subm = np.full((23, 23), -4.0, np.float32)
    np.fill_diagonal(subm, 5.0)
    ap = SimpleNamespace(subm=subm, gpo=8.0, gpe=6.0, tgpe=0.0)
    pairs = [(2 * k, 2 * k + 1) for k in range(MESH_PAIRS)]
    spec = [(len(codes[a]), False) for a, _ in pairs]
    seen = {}
    orig = E.maps_from_steps

    def rec(steps, swapped, Lmax):
        seen.setdefault(rec.side, []).extend(
            s[s != 3].copy() for s in np.asarray(steps))
        return orig(steps, swapped, Lmax)
    E.maps_from_steps = rec
    line = {}
    try:
        for side in ("one_card", "mesh"):
            rec.side = side
            if side == "one_card":
                eng = E.GpuEngine("cuda:0")
            else:
                eng = E.GpuEngine(mesh=mesh_of())
                eng.map_sharded = lambda L1p, L2p: True
            torch.cuda.empty_cache()
            for d in range(torch.cuda.device_count()):
                torch.cuda.reset_peak_memory_stats(d)
            t0 = time.perf_counter()
            maps = eng.dp_leaf_batch(codes, pairs, ap, spec)
            torch.cuda.synchronize()
            line[side] = dict(wall_s=round(time.perf_counter() - t0, 3),
                              card_peaks_gb=card_peaks_gb(),
                              routes=sorted({b["route"] for b in
                                             eng.stats["batches"]}))
            line[side + "_maps"] = maps
            if side == "mesh":
                line[side].update(long_maps=eng.stats["long_maps"],
                                  walk_handoffs=eng.stats["walk_handoffs"],
                                  dec_moved_bytes=eng.stats[
                                      "dec_moved_bytes"])
    finally:
        E.maps_from_steps = orig
    same = len(seen["one_card"]) == len(seen["mesh"]) == MESH_PAIRS and \
        all(np.array_equal(a, b) for a, b in zip(seen["one_card"],
                                                  seen["mesh"]))
    same_maps = all(np.array_equal(a, b) for a, b in zip(
        line.pop("one_card_maps"), line.pop("mesh_maps")))
    hold("traceback", same and same_maps, 0.0 if same else 1.0,
         f"{MESH_PAIRS} map DPs of ~236 kb pairs: the column-sharded route "
         "over the cards vs one card's wave route (steps, maps)")
    emit({"phase": "mesh_pairs", "pairs": MESH_PAIRS,
          "lengths": [[len(codes[a]), len(codes[b])] for a, b in pairs],
          "steps": [len(x) for x in seen["mesh"]], **line})


def phase_mesh_rows():
    """Rows a launch of bands alone on their cards (gotoh_mesh.ALONE_ROWS
    against BLOCK_ROWS): one consistency-map DP of two ~295 kb genomes (a
    random root and a copy at 0.4 % substitutions) column-sharded over
    every card through a LongQueue, each rows value in turns, twice: the
    host's queueing (submit, the span mesh.bands), the wall to the steps
    on the host, equal steps and score."""
    import torch
    from kalign_tpu_torch.gpu import gotoh_mesh
    from kalign_tpu_torch.gpu.engine import leaf_operands
    from kalign_tpu_torch.parallel import mesh as M
    rng = np.random.default_rng(37)
    a = rng.integers(0, 4, 295146).astype(np.uint8)
    b = a.copy()
    hit = rng.random(len(b)) < 0.004
    b[hit] = rng.integers(0, 4, int(hit.sum()))
    b = np.delete(b, slice(1000, 1011))
    L1p, L2p = (-(-len(x) // 128) * 128 for x in (b, a))
    tok = torch.from_numpy(np.stack([np.pad(b, (0, len(a) - len(b))), a]))
    subm = torch.full((23, 23), -4.0)
    subm.fill_diagonal_(5.0)
    penv = torch.tensor([-8.0, -6.0, 0.0])
    one = lambda v: torch.tensor([v], dtype=torch.int32)
    lhs, rhs, pc, pr = (x[0].numpy() for x in leaf_operands(
        tok, subm, penv, one(0), one(1), one(len(b)), one(len(a)), L1p,
        L2p))
    mesh = mesh_of()
    out, want = {}, None
    for turn in range(2):
        for rows in (gotoh_mesh.BLOCK_ROWS, gotoh_mesh.ALONE_ROWS):
            q = M.LongQueue(mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dp = q.submit(lhs, rhs, pc, pr, len(b), len(a), 0.0, rows=rows)
            t1 = time.perf_counter()
            steps, score = q.walk(dp)
            t2 = time.perf_counter()
            if want is None:
                want = (steps, score)
            hold("gotoh_mesh", np.array_equal(steps, want[0])
                 and score == want[1], 0.0,
                 f"a 295 kb map DP at {rows} rows a launch")
            out.setdefault(str(rows), []).append(
                dict(queue_s=round(t1 - t0, 4), wall_s=round(t2 - t0, 4)))
            del q, dp
    emit({"phase": "mesh_rows", "L1p": L1p, "L2p": L2p, "cards": mesh.cards,
          "band": gotoh_mesh.band_width(L2p, mesh.size,
                                        gotoh_mesh.alone(mesh.shards)),
          "rows": out, "steps": len(want[0])})


def run_only(dev, only, divergent_n=DIVERGENT_N):
    """The phases named in ``--only`` (comma-separated: edge, wave_edge,
    prepare_edge, tree_pairs, kmeans_edge, kmeans, exact_edge, path:NAME,
    profile:NAME, vs, goldens, mesh_edge, path:mesh_default,
    path:mesh_long, path:mesh_sars2, path:mesh_plastome, path:mesh_wide
    (and wide_merge on its widest merge), path:hcmv_default,
    path:mesh_hcmv, mesh_walk, mesh_pairs, mesh_rows, mesh_sweep
    (mesh_sweep:alone: its sweep of a band alone on its card only),
    profile:mesh_long, mesh_procs, launch_memory), for a short call; no
    result lines.  path:plastome_default also holds and times the wave
    route and the match preparation at its root merge (wave_main_shape,
    prepare_main_shape).  mesh_sweep runs
    phase_mesh_sweep on the merges of path:mesh_long and path:mesh_wide
    (each run here first where it was not named before it).  path:precise runs phase_precise,
    path:serve phase_serve.  path:divergent also holds and times the sweep at
    its largest launch, path:long_default the cluster row kernel at its
    largest map-DP and progressive launches."""
    protein = lambda: family(2000, seed=0)
    seqs = {"default": lambda: v4_family(2000, seed=2),
            "large_default": large_family, "long_default": long_genomes,
            "sars2_default": sars2_genomes,
            "plastome_default": plastome_genomes,
            "hcmv_default": hcmv_genomes}
    seen = wide_seen = None
    for what in only.split(","):
        if what == "edge":
            phase_edge_cases(dev)
        elif what == "exact_edge":
            phase_exact_edge(dev)
        elif what in ("path:divergent", "profile:divergent"):
            s = divergent_family(divergent_n)
            launches, largest = phase_divergent(s)
            emit({"phase": "main_shape", "kernel": "exact_sweep",
                  **sweep_main_shape(dev, largest)})
            if what.startswith("profile"):
                phase_profile("divergent", s, launches)
        elif what == "tree_pairs":
            edge_cases_tree_pairs(dev)
        elif what == "kmeans_edge":
            edge_cases_kmeans(dev, np.random.default_rng(7))
        elif what == "kmeans":
            phase_kmeans(dev, large_family())
        elif what in ("path:precise", "profile:precise"):
            s = precise_family()
            launches, _ = phase_precise(dev, s)
            if what.startswith("profile"):
                phase_profile("precise", s, launches)
        elif what == "goldens":
            phase_goldens(dev)
        elif what == "path:serve":
            phase_serve(dev)
        elif what == "path:mesh_default":
            phase_mesh_path("mesh_default", protein())
        elif what == "path:mesh_long":
            _, _, seen = phase_mesh_path("mesh_long", long_genomes())
            mesh_root_merge(dev, seen)
        elif what in ("path:mesh_sars2", "path:mesh_plastome",
                      "path:mesh_hcmv"):
            path = what.split("_")[1]
            phase_mesh_path(what[5:], seqs[f"{path}_default"]())
        elif what == "path:mesh_wide":
            _, _, wide_seen = phase_mesh_path("mesh_wide", wide_family())
            wide_merge(dev, wide_seen)
        elif what == "mesh_walk":
            phase_mesh_walk(dev)
        elif what == "mesh_pairs":
            phase_mesh_pairs()
        elif what == "mesh_rows":
            phase_mesh_rows()
        elif what == "mesh_sweep:alone":
            sweep_alone()
        elif what == "mesh_sweep":
            sweep_alone()
            if wide_seen is None:
                _, _, wide_seen = phase_mesh_path("mesh_wide", wide_family())
            if seen is None:
                _, _, seen = phase_mesh_path("mesh_long", long_genomes())
            phase_mesh_sweep(seen, wide_seen)
        elif what == "profile:mesh_long":
            profile_mesh_host()
        elif what == "wave_edge":
            phase_wave_edge(dev)
        elif what == "prepare_edge":
            edge_cases_prepare(dev, np.random.default_rng(16))
            emit({"phase": "prepare_edge", "ok": True,
                  "cases": len(PREPARE_EDGE)})
        elif what == "launch_memory":
            emit({"phase": "launch_memory", **launch_memory(dev)})
        elif what.startswith(("path:", "profile:")):
            kind, path = what.split(":")
            s = seqs.get(path, protein)()
            wave_seen = []
            with recorded_wave_calls(wave_seen):
                launches, stats = phase_path(path, s)
            if path == "long_default":
                cluster_main_shape(dev, stats)
            if path == "plastome_default":
                wave_main_shape(dev, wave_seen)
                prepare_main_shape(dev, wave_seen, None)
                wave_seen.clear()
            if kind == "profile":
                phase_profile(path, s, launches)
        elif what == "vs":
            phase_gpu_vs_cpu()
        elif what == "mesh_edge":
            phase_mesh_edge(dev)
        elif what == "mesh_procs":
            phase_mesh_procs()
        else:
            raise ValueError(f"--only: unknown phase {what!r}")
    emit({"phase": "partial", "only": only})


def main(argv=None):
    import argparse
    import torch
    parser = argparse.ArgumentParser(description="chip smoke run")
    parser.add_argument("--only", default=None,
                        help="run only these phases (see run_only)")
    parser.add_argument("--log", default=None,
                        help="also append every JSON line to this file")
    parser.add_argument("--divergent-n", type=int, default=DIVERGENT_N,
                        help="sequences of the divergent path")
    args = parser.parse_args(argv)
    global LOG
    if args.log:
        os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
        LOG = args.log
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.exists(os.path.join(HERE, "kalign_tpu_torch",
                                       "__init__.py")):
        print("chip_smoke: run from a checkout of the repository "
              "(kalign_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = phase_device_and_build()
    try:
        return run_all(dev, smi, args)
    finally:
        stop_host()


def run_all(dev, smi, args):
    """Every phase (or --only's), then the result lines."""
    import torch
    if args.only:
        run_only(dev, args.only, args.divergent_n)
        settle()
        return 0
    phase_edge_cases(dev)
    edge_cases_kmeans(dev, np.random.default_rng(7))
    phase_exact_edge(dev)
    protein = family(2000, seed=0)
    seqs = {"fast": protein, "default": v4_family(2000, seed=2),
            "protein_default": protein, "large_default": large_family(),
            "refine_confident": protein, "long_default": long_genomes(),
            "sars2_default": sars2_genomes(),
            "plastome_default": plastome_genomes(),
            "divergent": divergent_family(args.divergent_n)}
    launches, stats = {}, {}
    wave_seen = []
    for path in PATHS:
        with recorded_wave_calls(wave_seen):
            launches[path], stats[path] = phase_path(path, seqs[path])
    launches["divergent"], sweep_largest = phase_divergent(
        seqs["divergent"])
    launches["precise"], precise_row = phase_precise(dev, precise_family())
    # handed out after the precise path, whose host loops they slowed
    vs_cpu = vs_cpu_sides()
    launches["serve"] = phase_serve(dev)
    wave_edge = phase_mesh_edge(dev)
    seen = {}
    for name, path in (("mesh_default", "protein_default"),
                       ("mesh_long", "long_default"),
                       ("mesh_sars2", "sars2_default"),
                       ("mesh_plastome", "plastome_default")):
        launches[name], stats[name], seen[name] = phase_mesh_path(
            name, seqs[path])
    launches["mesh_wide"], stats["mesh_wide"], seen["mesh_wide"] = \
        phase_mesh_path("mesh_wide", wide_family())
    mesh_root = mesh_root_merge(dev, seen["mesh_long"])
    mesh_wide = wide_merge(dev, seen["mesh_wide"])
    seen.clear()
    launches["mesh_procs"] = phase_mesh_procs()
    # the divergent path's profiled run (50 s of PR 16's first whole run
    # of 1,093 s) runs only under --only profile:divergent
    for path in PATHS:
        if PATHS[path].get("profile", True):
            phase_profile(path, seqs[path], launches[path])
    kmeans_root = phase_kmeans(dev, seqs["large_default"])
    vs_launches, vs_stats = phase_gpu_vs_cpu(vs_cpu)
    phase_goldens(dev)
    launches.update({k: v for k, v in vs_launches.items()
                     if k.startswith(("long", "BB11001"))})
    shapes = phase_main_shapes(dev, stats["fast"], stats["default"], seqs)
    shapes["gotoh_row"]["precise"] = precise_row
    shapes["gotoh_row_cluster"] = cluster_main_shape(
        dev, stats["long_default"], vs_stats["long-fast"])
    shapes["gotoh_row_wave"] = wave_main_shape(dev, wave_seen)
    shapes["prepare_match"] = prepare_main_shape(dev, wave_seen,
                                                 stats["long_default"])
    wave_seen.clear()
    shapes["kmeans"] = kmeans_root
    shapes["exact_sweep"] = sweep_main_shape(dev, sweep_largest)
    shapes[MESH_ROUTES[mesh_root["route"]]] = mesh_root
    shapes["gotoh_mesh"] = dict(wave_edge[64], full_block=wave_edge[512],
                                whole_merge=mesh_wide)
    emit({"phase": "main_shape", "kernel": "gotoh_mesh",
          **shapes["gotoh_mesh"]})
    emit({"phase": "main_shape", "kernel": "exact_sweep",
          **shapes["exact_sweep"]})
    t0 = time.perf_counter()
    settle()
    emit({"phase": "settled", "wait_s": round(time.perf_counter() - t0, 1),
          "plain_ms": {k: shapes[k].get("plain_ms") for k in (
              "gotoh_lanewise", "gotoh_fused")}})
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        t = shapes[name]
        main = {"gotoh_row_cluster": ("long_default",),
                "gotoh_row_wave": ("plastome_default",),
                "prepare_match": ("plastome_default",),
                "kmeans": ("large_default",),
                "exact_sweep": ("divergent",),
                "gotoh_mesh": ("mesh_wide",),
                "gotoh_mesh_cluster": ("mesh_long",)}.get(name, ("default",))
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(launches[p][name] for p in main),
            "launches_by_path": {p: launches[p][name] for p in launches},
            "max_abs_err": MAX_ABS_ERR[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t.get("library_ms"),
            **{k: v for k, v in t.items() if k not in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    total_s = time.perf_counter() - T_START
    emit({"phase": "total", "total_s": round(total_s, 1)})
    line = json.dumps({"kernels": kernels})
    print(line)
    if LOG is not None:
        with open(LOG, "a") as fh:
            fh.write(line + "\n")
    print(f"total_s {total_s:.1f}", file=sys.stderr)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
