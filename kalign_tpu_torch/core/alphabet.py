"""Alphabet encoding tables.

Re-derives the reference's char->code tables (``lib/src/alphabet.c``) from
the same published merge rules:

  * ambiguous protein: 23 codes in "ARNDCQEGHILKMFPSTWYVBZX" order, U->X
    (``alphabet.c:179-203``) — used for alignment DP.
  * reduced protein: Steinegger/Soeding 13-letter clustering alphabet with
    merges (L,M) (I,V) (K,R) (E,Q) (A,S,T) (N,D) (F,Y), B->(N,D), Z->(E,Q),
    U->C (``alphabet.c:248-302``) — used for BPM distance estimation.
  * DNA: "ACGTUNRYSWKMBDHV" with U->T and all IUPAC ambiguity codes merged
    into N (``alphabet.c:206-245``) — 5 effective codes.

Tables are materialized as 128-entry int8 numpy arrays; -1 marks characters
outside the alphabet (the engine maps those to code 0 with a warning, as in
``msa_op.c:358-364``).
"""

import numpy as np

# type ids (match kalign's ALPHA_* usage where it matters for MSF headers)
ALPHA_UNDEFINED = 0
ALPHA_AMBIGUOUS_PROTEIN = 1
ALPHA_DEFAULT_PROTEIN = 2
ALPHA_REDUCED_PROTEIN = 3
ALPHA_DEFAULT_DNA = 4


def _empty_tables():
    to_internal = np.full(128, -1, dtype=np.int8)
    return to_internal


def _merge(to_internal, x, y):
    cx, cy = to_internal[ord(x)], to_internal[ord(y)]
    m = min(int(cx), int(cy))
    assert m != -1, "merge of unset code"
    to_internal[ord(x)] = m
    to_internal[ord(y)] = m


def _compact(to_internal):
    """Renumber codes to 0..L-1 in ascending raw-code order and mirror
    uppercase codes onto lowercase (chars 64..95 -> +32), as in
    ``alphabet.c:399-437``."""
    trans = np.full(32, -1, dtype=np.int8)
    for i in range(64, 96):
        if to_internal[i] != -1:
            trans[to_internal[i]] = 1
    code = 0
    for i in range(32):
        if trans[i] == 1:
            trans[i] = code
            code += 1
    L = code
    out = np.full(128, -1, dtype=np.int8)
    for i in range(64, 96):
        if to_internal[i] != -1:
            out[i] = trans[to_internal[i]]
            out[i + 32] = out[i]
    return out, L


def _build_ambiguous_protein():
    t = _empty_tables()
    for code, ch in enumerate("ARNDCQEGHILKMFPSTWYVBZX"):
        t[ord(ch)] = code
    t[ord("U")] = t[ord("X")]  # non-IUPAC selenocysteine -> ambiguous
    return _compact(t)


def _build_default_protein():
    t = _empty_tables()
    for code, ch in enumerate("ACDEFGHIKLMNPQRSTVWY"):
        t[ord(ch)] = code
    for ch in "BZXU":
        t[ord(ch)] = 20
    return _compact(t)


def _build_reduced_protein():
    t = _empty_tables()
    for code, ch in enumerate("ACDEFGHIKLMNPQRSTVWY"):
        t[ord(ch)] = code
    t[ord("B")] = 20
    t[ord("Z")] = 21
    t[ord("X")] = 22
    _merge(t, "L", "M")
    _merge(t, "I", "V")
    _merge(t, "K", "R")
    _merge(t, "E", "Q")
    _merge(t, "A", "S")
    _merge(t, "A", "T")
    _merge(t, "S", "T")
    _merge(t, "N", "D")
    _merge(t, "F", "Y")
    _merge(t, "B", "N")
    _merge(t, "B", "D")
    _merge(t, "Z", "E")
    _merge(t, "Z", "Q")
    t[ord("U")] = t[ord("C")]
    return _compact(t)


def _build_default_dna():
    t = _empty_tables()
    for code, ch in enumerate("ACGTUNRYSWKMBDHV"):
        t[ord(ch)] = code
    _merge(t, "U", "T")
    for ch in "RYSWKMBDHV":
        _merge(t, "N", ch)
    return _compact(t)


_AMBIG_PROT, _L_AMBIG_PROT = _build_ambiguous_protein()
_DEF_PROT, _L_DEF_PROT = _build_default_protein()
_RED_PROT, _L_RED_PROT = _build_reduced_protein()
_DEF_DNA, _L_DEF_DNA = _build_default_dna()

_TABLES = {
    ALPHA_AMBIGUOUS_PROTEIN: (_AMBIG_PROT, _L_AMBIG_PROT),
    ALPHA_DEFAULT_PROTEIN: (_DEF_PROT, _L_DEF_PROT),
    ALPHA_REDUCED_PROTEIN: (_RED_PROT, _L_RED_PROT),
    ALPHA_DEFAULT_DNA: (_DEF_DNA, _L_DEF_DNA),
}


def get_alphabet(kind):
    """Return (to_internal[128] int8 table, number of codes L)."""
    return _TABLES[kind]


def encode(seq_bytes: np.ndarray, kind: int) -> np.ndarray:
    """Encode ASCII byte array -> uint8 codes.  Unknown chars map to 0
    (reference warns and uses 0, ``msa_op.c:358-364``)."""
    table, _ = _TABLES[kind]
    codes = table[np.minimum(seq_bytes, 127)]
    return np.where(codes < 0, 0, codes).astype(np.uint8)
