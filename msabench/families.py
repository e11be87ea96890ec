"""Synthetic sequence families from a seed, with their true homology.

Grown from a frozen copy of chip_smoke.py's ``family`` (lines 642-672;
the parameters of its ``sars2_genomes`` :717 and ``plastome_genomes``
:726 were the first files in configs/, its defaults the protein
family's): a root sequence, clade ancestors with substitutions and
indels, members with more.  With the defaults it draws chip_smoke's
random numbers in chip_smoke's order.  A configuration may instead give
indels per kilobase (``indels_per_kb``: the count scales with the
sequence's length) and a list the indel lengths are drawn from
(``indel_lengths``).

Every residue carries the id of its origin: a root position
(0 .. root_len - 1), or a fresh id for an inserted residue, which the
insertion's descendants inherit.  Two residues are homologous when
their ids are equal; that is the true alignment the checks
(msabench/checks/) judge the program's rows against.  Member i belongs
to clade i % clades.
"""

import numpy as np

ALPHABETS = {"protein": "ARNDCQEGHILKMFPSTWYV", "dna": "ACGT"}


def family(n: int, seed, root_len: int = 300, lo: int = 270, hi: int = 330,
           clades: int = 16, alphabet: str = "protein", subs=(0.12, 0.08),
           max_indel: int = 4, p_del: float = 0.5, indels=(3, 2),
           indels_per_kb=None, indel_lengths=None):
    """(sequences [n] str, ids [n] int64 arrays): a root of root_len
    letters, ``clades`` ancestors with subs[0] substitutions and indels,
    members (member i of clade i % clades) with subs[1] more.  The
    indels of an ancestor and of a member are Poisson(indels[0]) and
    Poisson(indels[1]), or, with indels_per_kb, Poisson of that rate
    times the sequence's length in kb; each of 1..max_indel letters, or
    of a length drawn from indel_lengths; a deletion with probability
    p_del.  Lengths are kept within [lo, hi].  ``seed`` is anything
    np.random.default_rng takes."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(ALPHABETS[alphabet].encode(), np.uint8)
    na = len(alpha)
    fresh = [root_len]

    def n_indels(level, length):
        if indels_per_kb is None:
            return int(rng.poisson(indels[level]))
        return int(rng.poisson(indels_per_kb[level] * length / 1000.0))

    def indel_len():
        if indel_lengths is None:
            return int(rng.integers(1, max_indel + 1))
        return int(indel_lengths[rng.integers(0, len(indel_lengths))])

    def mutate(seq, ids, sub, n_indel):
        seq = seq.copy()
        mask = rng.random(len(seq)) < sub
        seq[mask] = alpha[rng.integers(0, na, int(mask.sum()))]
        for _ in range(n_indel):
            k = indel_len()
            pos = int(rng.integers(0, len(seq)))
            if rng.random() < p_del and len(seq) - k >= lo:
                seq = np.delete(seq, slice(pos, pos + k))
                ids = np.delete(ids, slice(pos, pos + k))
            elif len(seq) + k <= hi:
                seq = np.insert(seq, pos, alpha[rng.integers(0, na, k)])
                ids = np.insert(ids, pos, np.arange(fresh[0], fresh[0] + k))
                fresh[0] += k
        return seq, ids

    root = alpha[rng.integers(0, na, root_len)]
    root_ids = np.arange(root_len, dtype=np.int64)
    anc = [mutate(root, root_ids, subs[0], n_indels(0, root_len))
           for _ in range(clades)]
    seqs, ids = [], []
    for i in range(n):
        a_seq, a_ids = anc[i % clades]
        s, d = mutate(a_seq, a_ids, subs[1], n_indels(1, len(a_seq)))
        seqs.append(s.tobytes().decode())
        ids.append(d)
    return seqs, ids


def of_config(cfg: dict, seed: int, k: int, n=None):
    """Family k of a run with ``seed`` (the run's families differ by k):
    a configuration's ``sequences`` (or n) under its ``family``
    parameters."""
    p = dict(cfg["family"])
    for key in ("subs", "indels", "indels_per_kb"):
        if key in p:
            p[key] = tuple(p[key])
    return family(cfg["sequences"] if n is None else n,
                  [int(seed), int(k)], **p)
