"""DSSim: profile-HMM sequence simulator for test data generation.

Bit-exact port of the reference simulator (tests/dssim.c) using the same
xoshiro256** RNG, so `generate_test_sequences(seed=s)` emits the exact
sequences the reference's `kalign.generate_test_sequences` would; a copy
of kalign_tpu/dssim.py on this package's utils/rng.py.

Model: per-position match/insert emission distributions sampled from a
Dirichlet-ish prior with per-"observed sequence" noise, plus a 7-way
transition table (match/insert/delete).
"""

from typing import List, Tuple

from kalign_tpu_torch.utils.rng import XoshiroRng

TMM, TMI, TMD, TII, TIM, TDD, TDM = range(7)
HMM_MATCH, HMM_INSERT, HMM_DELETE = range(3)

_PROT_PRIOR = [
    0.075520, 0.016973, 0.053029, 0.063204, 0.040762, 0.068448, 0.022406,
    0.057284, 0.059398, 0.093399, 0.023569, 0.045293, 0.049262, 0.040231,
    0.051573, 0.072214, 0.057454, 0.065252, 0.012513, 0.031985,
]
_DNA_PRIOR = [0.2, 0.3, 0.3, 0.2]
_PROT_ALPHA = "ACDEFGHIKLMNPQRSTVWY"
_DNA_ALPHA = "ACGT"


def _sample_pick(p: List[float], rng: XoshiroRng) -> int:
    r = rng.random_double()
    s = 0.0
    for i, v in enumerate(p):
        s += v
        if r < s:
            return i
    return -1


class _Hmm:
    def __init__(self, length: int, seed: int, dna: bool,
                 n_observed: int, indel_p: float,
                 match_err_p: float = 0.05, insert_err_p: float = 0.25):
        self.rng = XoshiroRng(seed if seed else 42)
        self.L = 4 if dna else 20
        self.len = length
        prior_e = list(_DNA_PRIOR if dna else _PROT_PRIOR)
        s = sum(prior_e)
        prior_e = [x / s for x in prior_e]
        prior_t = [0.96, 0.02, 0.02, 0.50, 0.50, 0.50, 0.50]
        prior_t[TMM] = 1.0 - indel_p
        prior_t[TMI] = indel_p / 2.0
        prior_t[TMD] = indel_p / 2.0
        # reference normalizes sequentially, reusing the updated TMM
        # (dssim.c:355-361) — replicated exactly
        tot = prior_t[TMM] + prior_t[TMI] + prior_t[TMD]
        prior_t[TMM] = prior_t[TMM] / tot
        tot2 = prior_t[TMM] + prior_t[TMI] + prior_t[TMD]
        prior_t[TMI] = prior_t[TMI] / tot2
        tot3 = prior_t[TMM] + prior_t[TMI] + prior_t[TMD]
        prior_t[TMD] = prior_t[TMD] / tot3

        rng = self.rng
        self.match_emit = []
        self.insert_emit = []
        self.transition = []
        for _ in range(length):
            me = [0.0] * self.L
            ie = [0.0] * self.L
            pick = _sample_pick(prior_e, rng)
            for _ in range(n_observed):
                r = rng.random_double()
                if r < match_err_p:
                    me[rng.random_int(self.L)] += 1.0
                else:
                    me[pick] += 1.0
            pick = _sample_pick(prior_e, rng)
            for _ in range(n_observed):
                r = rng.random_double()
                if r < insert_err_p:
                    ie[rng.random_int(self.L)] += 1.0
                else:
                    ie[pick] += 1.0
            for j in range(self.L):
                me[j] += prior_e[j]
                ie[j] += prior_e[j]
            sm = sum(me)
            me = [x / sm for x in me]
            si = sum(ie)
            ie = [x / si for x in ie]
            self.match_emit.append(me)
            self.insert_emit.append(ie)
            self.transition.append(list(prior_t))

    def emit(self, trace: List[Tuple[int, int]] = None) -> str:
        """Emit one sequence.  When `trace` is given, records one
        (state, hmm_pos) tuple per emitted residue — the ground-truth
        homology used to build gold alignments for simulated
        benchmarks.  Recording consumes no randomness, so sequences
        are unchanged (bit-exact with dssim.c either way)."""
        rng = self.rng
        alpha = _PROT_ALPHA if self.L == 20 else _DNA_ALPHA
        out = []
        pos = 0
        state = rng.random_int(3)
        while pos + 1 < self.len:
            if state == HMM_MATCH:
                r = rng.random_double()
                s = self.transition[pos][TMM]
                if r < s:
                    state = HMM_MATCH
                else:
                    s += self.transition[pos][TMI]
                    if r < s:
                        state = HMM_INSERT
                    else:
                        s += self.transition[pos][TMD]
                        if r < s:
                            state = HMM_DELETE
                pos += 1
            elif state == HMM_INSERT:
                r = rng.random_double()
                if r < self.transition[pos][TII]:
                    state = HMM_INSERT
                else:
                    state = HMM_MATCH
                    pos += 1
            else:
                r = rng.random_double()
                if r < self.transition[pos][TDD]:
                    state = HMM_DELETE
                    pos += 1
                else:
                    state = HMM_MATCH
                    pos += 1

            if state == HMM_MATCH:
                out.append(alpha[_sample_pick(self.match_emit[pos], rng)])
                if trace is not None:
                    trace.append((HMM_MATCH, pos))
            elif state == HMM_INSERT:
                out.append(alpha[_sample_pick(self.insert_emit[pos], rng)])
                if trace is not None:
                    trace.append((HMM_INSERT, pos))
        return "".join(out)


def generate_test_sequences(n_seq: int = 20, n_obs: int = 10,
                            dna: bool = False, length: int = 250,
                            seed: int = 42) -> Tuple[List[str], List[str]]:
    """Returns (sequences, names); names are '1'..'n' like the reference
    (dssim.c:131)."""
    indel_p = 0.02 if n_seq > 100 else 0.04
    hmm = _Hmm(length, seed, dna, n_obs, indel_p)
    seqs = [hmm.emit() for _ in range(n_seq)]
    names = [str(i + 1) for i in range(n_seq)]
    return seqs, names


def generate_test_alignment(n_seq: int = 20, n_obs: int = 10,
                            dna: bool = False, length: int = 250,
                            seed: int = 42, indel_p: float = None,
                            match_err_p: float = 0.05,
                            insert_err_p: float = 0.25):
    """Simulated family WITH its ground-truth alignment.

    Returns (sequences, names, gold_rows): residues emitted by the same
    HMM match state share a column; insert runs occupy left-justified
    filler columns between match columns (non-homologous — they exceed
    any sane core-column gap threshold and are excluded from SP/TC
    scoring, exactly like BAliBASE non-core blocks).

    The divergence knobs map onto the simulator's priors: lower `n_obs`
    and higher `match_err_p` mean noisier emission profiles (more
    diverged families); `indel_p` sets the match->indel transition mass
    (defaults to the reference's n_seq rule, dssim.c:128)."""
    if indel_p is None:
        indel_p = 0.02 if n_seq > 100 else 0.04
    hmm = _Hmm(length, seed, dna, n_obs, indel_p,
               match_err_p=match_err_p, insert_err_p=insert_err_p)
    seqs = []
    traces = []
    for _ in range(n_seq):
        tr: List[Tuple[int, int]] = []
        seqs.append(hmm.emit(tr))
        traces.append(tr)
    names = [str(i + 1) for i in range(n_seq)]

    # column plan: per HMM position, the match column plus a filler
    # block wide enough for the longest insert run observed there
    max_ins = [0] * (length + 1)
    for tr in traces:
        run = 0
        last_pos = -1
        for st, pos in tr:
            if st == HMM_INSERT:
                run = run + 1 if pos == last_pos else 1
                last_pos = pos
                if run > max_ins[pos]:
                    max_ins[pos] = run
            else:
                run = 0
                last_pos = -1
    col_of_match = [0] * (length + 1)
    col = 0
    for p in range(length + 1):
        col_of_match[p] = col
        col += 1 + max_ins[p]
    total_cols = col

    rows = []
    for seq, tr in zip(seqs, traces):
        row = ["-"] * total_cols
        ins_run = 0
        last_pos = -1
        for ch, (st, pos) in zip(seq, tr):
            if st == HMM_MATCH:
                row[col_of_match[pos]] = ch
                ins_run = 0
                last_pos = -1
            else:
                ins_run = ins_run + 1 if pos == last_pos else 1
                last_pos = pos
                row[col_of_match[pos] + ins_run] = ch
        rows.append("".join(row))

    # drop all-gap columns (match states skipped by every sequence)
    keep = [c for c in range(total_cols)
            if any(r[c] != "-" for r in rows)]
    rows = ["".join(r[c] for c in keep) for r in rows]
    return seqs, names, rows
