"""MSA data model.

A fresh design around numpy arrays (ragged sequences kept host-side as
byte arrays; the GPU engine converts to padded ``tokens[N, Lmax]`` +
``lengths[N]`` when shipping to device), reproducing the semantics of the
reference's gap-list representation (``lib/src/msa_struct.h:23-53``):

  * ``gaps[i]`` = number of alignment gaps placed *before* residue ``i``;
    ``gaps[len]`` = trailing gaps.  An alignment is fully described by each
    member's gap list; ``finalise`` expands them to '-' strings.

Also implements alphabet / aligned-status detection and the length+name /
rank sorts (``msa_op.c``, ``msa_sort.c``) with glibc-qsort-compatible tie
handling.
"""

import math
from typing import List, Optional

import numpy as np

from kalign_tpu_torch.core import alphabet as alpha
from kalign_tpu_torch.utils.sorting import glibc_msort

# aligned-status codes (msa_struct.h:14-17)
ALN_STATUS_UNALIGNED = 1
ALN_STATUS_ALIGNED = 2
ALN_STATUS_FINAL = 3
ALN_STATUS_UNKNOWN = 3  # same value as FINAL in the reference header

BIOTYPE_PROTEIN = 0
BIOTYPE_DNA = 1
BIOTYPE_UNDEF = 2


class MsaSeq:
    __slots__ = ("name", "seq", "s", "gaps", "confidence", "rank", "len")

    def __init__(self, name: str = "", seq: str = ""):
        self.name = name
        self.seq = seq              # residue characters only (no gaps) until finalise
        self.s: Optional[np.ndarray] = None  # internal uint8 codes
        self.gaps = [0] * (len(seq) + 1)
        self.confidence: Optional[List[float]] = None
        self.rank = 0
        self.len = len(seq)

    def copy(self) -> "MsaSeq":
        out = MsaSeq(self.name, self.seq)
        out.s = None if self.s is None else self.s.copy()
        out.gaps = list(self.gaps)
        out.confidence = None if self.confidence is None else list(self.confidence)
        out.rank = self.rank
        out.len = self.len
        return out


class Msa:
    def __init__(self):
        self.sequences: List[MsaSeq] = []
        self.letter_freq = np.zeros(128, dtype=np.int64)
        self.biotype = BIOTYPE_UNDEF
        self.aligned = 0
        self.alnlen = 0
        self.L = 0              # alphabet size after encode() (reference msa->L)
        self.alpha_kind = alpha.ALPHA_UNDEFINED
        self.quiet = True
        self.seq_distances: Optional[np.ndarray] = None
        self.col_confidence: Optional[np.ndarray] = None
        self.seq_weights: Optional[np.ndarray] = None
        # profile membership: sip[p] = list of sequence indices in profile p
        self.sip: List[Optional[List[int]]] = []
        self.nsip: List[int] = []
        self.plen: List[int] = []

    # ------------------------------------------------------------------
    @property
    def numseq(self) -> int:
        return len(self.sequences)

    @property
    def num_profiles(self) -> int:
        return 2 * self.numseq - 1

    # ------------------------------------------------------------------
    @classmethod
    def from_sequences(cls, seqs: List[str], names: Optional[List[str]] = None) -> "Msa":
        """Build an MSA from raw strings (gap characters allowed; punct
        counts as gaps exactly like the FASTA reader)."""
        m = cls()
        for idx, s in enumerate(seqs):
            name = names[idx] if names else f"seq{idx}"
            sq = MsaSeq(name=name)
            residues = []
            gaps = [0]
            for ch in s:
                m.letter_freq[min(ord(ch), 127)] += 1
                if ch.isalpha():
                    residues.append(ch)
                    gaps.append(0)
                elif _ispunct(ch):
                    gaps[-1] += 1
            sq.seq = "".join(residues)
            sq.len = len(sq.seq)
            sq.gaps = gaps
            m.sequences.append(sq)
        m.detect_alphabet()
        m.detect_aligned()
        m.set_sip_nsip()
        return m

    # ------------------------------------------------------------------
    def detect_alphabet(self):
        """Log-likelihood DNA-vs-protein classifier over letter_freq
        (``msa_op.c:142-213``)."""
        dna_letters = "acgtunACGTUN"
        protein_letters = "acdefghiklmnpqrstvwyACDEFGHIKLMNPQRSTVWY"
        dna_lp = np.full(128, math.log(0.0001 / 116.0))
        prot_lp = np.full(128, math.log(0.0001 / 88.0))
        for ch in dna_letters:
            dna_lp[ord(ch)] = math.log(0.9999 / 12.0)
        for ch in protein_letters:
            prot_lp[ord(ch)] = math.log(0.9999 / 40.0)
        nz = self.letter_freq > 0
        dna_prob = float(np.sum(dna_lp[nz] * self.letter_freq[nz]))
        prot_prob = float(np.sum(prot_lp[nz] * self.letter_freq[nz]))
        if dna_prob == prot_prob:
            self.L = alpha.ALPHA_UNDEFINED
        elif dna_prob > prot_prob:
            self.biotype = BIOTYPE_DNA
        else:
            self.biotype = BIOTYPE_PROTEIN

    def detect_aligned(self):
        """Mirror ``detect_aligned`` (msa_op.c:215-271)."""
        total_gaps = 0
        min_len, max_len = 2**31 - 1, 0
        for sq in self.sequences:
            g = sum(sq.gaps)
            total_gaps += g
            l = g + sq.len
            min_len = min(min_len, l)
            max_len = max(max_len, l)
        if total_gaps:
            self.aligned = ALN_STATUS_ALIGNED if min_len == max_len else ALN_STATUS_UNKNOWN
        else:
            self.aligned = ALN_STATUS_UNKNOWN if min_len == max_len else ALN_STATUS_UNALIGNED

    def dealign(self):
        for sq in self.sequences:
            sq.gaps = [0] * (sq.len + 1)
        self.aligned = ALN_STATUS_UNALIGNED

    def set_sip_nsip(self):
        n = self.numseq
        self.seq_weights = None
        self.sip = [[i] if i < n else None for i in range(2 * n - 1)]
        self.nsip = [1 if i < n else 0 for i in range(2 * n - 1)]
        self.plen = [0] * (2 * n - 1)

    # ------------------------------------------------------------------
    def essential_input_check(self):
        """Set ranks; drop zero-length sequences (``msa_check.c:66-141``)."""
        if self.numseq <= 1:
            raise ValueError(f"only {self.numseq} sequences found.")
        for i, sq in enumerate(self.sequences):
            sq.rank = i
        n_zero = sum(1 for sq in self.sequences if sq.len == 0)
        if n_zero:
            keep = [sq for sq in self.sequences if sq.len]
            self.sequences = keep
            if self.numseq <= 1:
                raise ValueError(f"only {self.numseq} sequences found.")
            self.set_sip_nsip()

    def shuffle_seq(self, rng):
        """Reference msa_shuffle_seq (msa_sort.c:46-58): in-place
        sequence shuffle driven by the xoshiro RNG — note the
        reference's double-modulo quirk (tl_random_int(n) % (n-i))."""
        n = self.numseq
        for i in range(n - 1):
            r = rng.random_int(n)
            j = i + r % (n - i)
            self.sequences[i], self.sequences[j] = \
                self.sequences[j], self.sequences[i]

    def sort_len_name(self):
        """Sort length DESC then name ASC (``msa_sort.c:62-80``)."""
        def cmp(a: MsaSeq, b: MsaSeq) -> int:
            if a.len > b.len:
                return -1
            if a.len == b.len:
                return -1 if a.name[:256] < b.name[:256] else 1
            return 1
        self.sequences = glibc_msort(self.sequences, cmp)

    def sort_rank(self):
        def cmp(a: MsaSeq, b: MsaSeq) -> int:
            return 1 if a.rank > b.rank else -1
        self.sequences = glibc_msort(self.sequences, cmp)

    # ------------------------------------------------------------------
    def encode(self, kind: int):
        """Encode all sequences into internal uint8 codes.  ``L`` tracks
        the alphabet SIZE like the reference (msa->L, e.g. 23 for the
        ambiguous protein alphabet) — the MSF writer keys off it."""
        self.alpha_kind = kind
        self.L = alpha.get_alphabet(kind)[1]
        for sq in self.sequences:
            b = np.frombuffer(sq.seq.encode("ascii", "replace"), dtype=np.uint8)
            sq.s = alpha.encode(b, kind)

    # ------------------------------------------------------------------
    def finalise(self):
        """Expand gap lists to '-' strings (``msa_op.c:546-573``).

        Vectorized: residue j lands at column cumsum(gaps[..j]+1)-1 of
        a '-'-filled row (same output as the per-character loop; the
        loop cost ~seconds at 10^4+ sequences)."""
        assert self.aligned == ALN_STATUS_ALIGNED, "Sequences are not aligned"
        import numpy as _np
        s0 = self.sequences[0]
        aln_len = sum(s0.gaps) + s0.len
        for sq in self.sequences:
            g = _np.asarray(sq.gaps, dtype=_np.int64)
            total = int(g.sum()) + sq.len
            row = _np.full(total, ord("-"), _np.uint8)
            if sq.len:
                res_cols = _np.cumsum(g[:-1] + 1) - 1
                row[res_cols] = _np.frombuffer(
                    sq.seq.encode("latin-1"), _np.uint8)[:sq.len]
            sq.seq = row.tobytes().decode("latin-1")
        self.alnlen = aln_len
        self.aligned = ALN_STATUS_FINAL

    def strip_gaps(self):
        """Remove '-' characters from finalized seqs and reset gap lists
        (used by realign, ``aln_wrap.c:449-504``)."""
        for sq in self.sequences:
            sq.seq = sq.seq.replace("-", "")
            sq.len = len(sq.seq)
            sq.gaps = [0] * (sq.len + 1)
        self.aligned = ALN_STATUS_UNALIGNED

    def aligned_rows(self) -> List[str]:
        assert self.aligned == ALN_STATUS_FINAL
        return [sq.seq for sq in self.sequences]

    def copy(self) -> "Msa":
        out = Msa()
        out.sequences = [sq.copy() for sq in self.sequences]
        out.letter_freq = self.letter_freq.copy()
        out.biotype = self.biotype
        out.aligned = self.aligned
        out.alnlen = self.alnlen
        out.L = self.L
        out.quiet = self.quiet
        out.seq_distances = None if self.seq_distances is None else self.seq_distances.copy()
        out.set_sip_nsip()
        return out


def _ispunct(ch: str) -> bool:
    o = ord(ch)
    return (33 <= o <= 47) or (58 <= o <= 64) or (91 <= o <= 96) or (123 <= o <= 126)


def gcg_checksum(seq: str) -> int:
    """GCG checksum (``msa_check.c:301-310``).  Vectorized for ASCII
    (the reader only ever produces ASCII residues; per-step mod equals
    mod of the positive total); non-ASCII falls back to the exact
    per-char loop (Python upper may be multi-char, e.g. eszett)."""
    try:
        b = np.frombuffer(seq.encode("ascii"), dtype=np.uint8) \
            .astype(np.int64)
    except UnicodeEncodeError:
        chk = 0
        for i, ch in enumerate(seq):
            chk = (chk + (i % 57 + 1) * ord(ch.upper())) % 10000
        return chk
    b = np.where((b >= 97) & (b <= 122), b - 32, b)
    w = (np.arange(b.size, dtype=np.int64) % 57) + 1
    return int((w * b).sum() % 10000)


def gcg_mult_checksum(rows: List[str]) -> int:
    """Whole-alignment GCG checksum (``msa_misc.c``)."""
    chk = 0
    for r in rows:
        chk = (chk + gcg_checksum(r)) % 10000
    return chk
