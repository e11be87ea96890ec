"""Alignment file I/O: FASTA / MSF / Clustal readers and writers.

Byte-compatible with the reference readers/writers in ``lib/src/msa_io.c``:

  * format autodetection over the first 100 lines (msa_io.c:248-346)
  * FASTA: names are the full header line after '>', including spaces
    (msa_io.c:412-481); alpha chars are residues, punctuation characters
    count as gaps before the next residue
  * MSF: names from "Name: ... Len:" header lines; sequence block lines
    matched by name prefix (msa_io.c:565-664)
  * Clustal: first line skipped, blocks reset at blank lines
  * writers: 60-column FASTA wrap; Clustal with "Kalign (version)" header;
    GCG MSF with checksums and date header (msa_io.c:668-1150)
"""

import time
from typing import List, Optional, Tuple

import numpy as np

from kalign_tpu_torch.core.msa import (
    Msa,
    MsaSeq,
    _ispunct,
    gcg_checksum,
    gcg_mult_checksum,
)
from kalign_tpu_torch.core import alphabet as alpha
from kalign_tpu_torch.version import KALIGN_COMPAT_VERSION

FORMAT_FA = 0
FORMAT_MSF = 1
FORMAT_CLU = 2
FORMAT_STO = 4
FORMAT_DETECT_FAIL = 3

MSA_NAME_LEN = 256


def _codepoints(text: str):
    """(codepoint array, decoder) — uint8 for ASCII text (4x less
    memory traffic than utf-32), uint32 otherwise."""
    try:
        b = text.encode("ascii")
        return (np.frombuffer(b, dtype=np.uint8),
                lambda a: a.tobytes().decode("ascii"))
    except UnicodeEncodeError:
        return (np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32),
                lambda a: a.astype("<u4").tobytes().decode("utf-32-le"))


def _cumsum_i(x):
    """Bool cumsum with an explicit narrow dtype — numpy's default
    bool->int64 accumulate path is ~16x slower at 10^8 elements."""
    return np.cumsum(x, dtype=np.int32 if x.size < 2**31 else np.int64)


def _char_counts(cp) -> np.ndarray:
    """Histogram of codepoints clamped to 0..127 (one bincount pass —
    cheaper than repeated 10^8-element comparison masks)."""
    if cp.dtype == np.uint8:
        c = np.bincount(cp, minlength=128)
        if c.size > 128:
            c[127] += c[128:].sum()
            c = c[:128]
        return c
    return np.bincount(np.minimum(cp, np.uint32(127)), minlength=128)


def _clean_lines(text: str) -> List[str]:
    """Reference reads with getline and truncates each line at the first
    control character (msa_io.c:376-395).  Vectorized: codepoints via a
    single buffer conversion; the common no-control-chars case is a
    plain split."""
    cp, dec = _codepoints(text)
    # the trailing-\n rule tests the ORIGINAL text (a dropped trailing
    # control char must not turn a real empty last line into a pop)
    trailing_nl = text.endswith("\n")
    counts = _char_counts(cp) if cp.size else np.zeros(128, np.int64)
    n_ctrl = int(counts[:32].sum() - counts[10])
    if cp.dtype != np.uint8:
        n_ctrl += int(np.count_nonzero(cp == 127))
    else:
        n_ctrl += int(counts[127])
    if n_ctrl:
        is_nl = cp == 10
        ctrl = ((cp < 32) | (cp == 127)) & ~is_nl
        # drop every char at or after its line's first control char
        ctrlcum = _cumsum_i(ctrl)
        lineid = _cumsum_i(is_nl) - is_nl
        base_per_line = np.concatenate(
            [[0], ctrlcum[np.flatnonzero(is_nl)]])
        base = base_per_line[lineid]
        keep = ((~ctrl) & ((ctrlcum - ctrl) == base)) | is_nl
        text = dec(cp[keep])
    out = text.split("\n")
    # split("\n") leaves a trailing empty element when text ends with \n;
    # getline would not produce that extra line.
    if trailing_nl and out and out[-1] == "":
        out.pop()
    return out


def detect_format(lines: List[str]) -> int:
    hints = [0, 0, 0]
    for line in lines[:100]:
        if line.startswith(">"):
            hints[0] += 1
        if "multiple sequence alignment" in line or "CLUSTAL W" in line or "CLUSTAL O" in line:
            hints[2] += 1
        if ("!!AA_MULTIPLE_ALIGNMENT" in line or "!!NA_MULTIPLE_ALIGNMENT" in line
                or "MSF:" in line):
            hints[1] += 1
    # Stockholm is unambiguous from its header (capability beyond the
    # reference, which has no Stockholm reader)
    for line in lines[:2]:
        if line.startswith("# STOCKHOLM"):
            return FORMAT_STO
    nset = sum(1 for h in hints if h)
    if nset == 0 or nset > 1:
        fmt = FORMAT_DETECT_FAIL
    if hints[0]:
        fmt = FORMAT_FA
    if hints[1]:
        fmt = FORMAT_MSF
    if hints[2]:
        fmt = FORMAT_CLU
    if nset == 0:
        fmt = FORMAT_DETECT_FAIL
    return fmt


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def _scan_residues(msa: Msa, sq: MsaSeq, residues: List[str], text: str):
    for ch in text:
        msa.letter_freq[min(ord(ch), 127)] += 1
        if ch.isalpha() and ord(ch) < 128:
            residues.append(ch)
            sq.gaps.append(0)
        elif _ispunct(ch):
            sq.gaps[-1] += 1


def read_fasta_lines(lines: List[str]) -> Msa:
    """Vectorized FASTA reader: ONE pass over the concatenated residue
    text (per-line and per-block scans see the same char stream — block
    lines concatenate with nothing between).  Semantics identical to
    the per-char _scan_residues loop: ASCII alphas are residues, ASCII
    punctuation increments the preceding gap count, everything else
    only feeds letter_freq (msa_io.c:412-483)."""
    msa = Msa()
    hdr_idx = [i for i, l in enumerate(lines) if l.startswith(">")]
    first = hdr_idx[0] if hdr_idx else len(lines)
    for line in lines[:first]:
        for ch in line:
            msa.letter_freq[min(ord(ch), 127)] += 1
            if ch.isalpha():
                raise ValueError("Encountered a sequence before encountering its name")
    if not hdr_idx:
        return msa

    texts = []
    starts = []
    pos = 0
    for k, h in enumerate(hdr_idx):
        end = hdr_idx[k + 1] if k + 1 < len(hdr_idx) else len(lines)
        t = "".join(lines[h + 1:end])
        texts.append(t)
        starts.append(pos)
        pos += len(t)
    big = "".join(texts)
    if big:
        cp, dec = _codepoints(big)
        counts = _char_counts(cp)
        msa.letter_freq += counts
        alpha_m = ((cp >= 65) & (cp <= 90)) | ((cp >= 97) & (cp <= 122))
        ridx = np.flatnonzero(alpha_m)
        res_str = dec(cp[ridx])
        bstarts = np.array(starts + [len(big)], dtype=np.int64)
        rsplit = np.searchsorted(ridx, bstarts)
        P = np.zeros(128, bool)
        P[33:48] = P[58:65] = P[91:97] = P[123:127] = True
        n_punct = int(counts[P].sum())
        no_punct = n_punct == 0       # unaligned input: all gaps zero
        if not no_punct:
            # chars that are neither residue nor punct (rare): count
            # them positionally so puncts-before can come from index
            # arithmetic instead of a 10^8-element cumsum —
            # puncts before pos p = p - alphas_before(p) - others_before(p)
            n_other = int(cp.size - ridx.size - n_punct)
            if n_other:
                punct_m = ((cp >= 33) & (cp <= 47)) \
                    | ((cp >= 58) & (cp <= 64)) | ((cp >= 91) & (cp <= 96)) \
                    | ((cp >= 123) & (cp <= 126))
                oidx = np.flatnonzero(~alpha_m & ~punct_m)
                pb_all = ridx - np.arange(ridx.size, dtype=np.int64) \
                    - np.searchsorted(oidx, ridx)
                pstart = bstarts - rsplit - np.searchsorted(oidx, bstarts)
            else:
                pb_all = ridx - np.arange(ridx.size, dtype=np.int64)
                pstart = bstarts - rsplit

    for k, h in enumerate(hdr_idx):
        sq = MsaSeq(name=lines[h][1:])
        msa.sequences.append(sq)
        if not big:
            sq.seq = ""
            sq.len = 0
            sq.gaps = [0]
            continue
        r0, r1 = int(rsplit[k]), int(rsplit[k + 1])
        if no_punct:
            sq.gaps = [0] * (r1 - r0 + 1)
            sq.seq = res_str[r0:r1]
            sq.len = r1 - r0
            continue
        p0, p1 = int(pstart[k]), int(pstart[k + 1])
        if r1 > r0:
            pb = pb_all[r0:r1] - p0
            gaps = np.empty(r1 - r0 + 1, dtype=np.int64)
            gaps[0] = pb[0]
            gaps[1:-1] = np.diff(pb)
            gaps[-1] = (p1 - p0) - pb[-1]
            sq.gaps = gaps.tolist()
        else:
            sq.gaps = [p1 - p0]
        sq.seq = res_str[r0:r1]
        sq.len = r1 - r0
    return msa


def read_clu_lines(lines: List[str]) -> Msa:
    msa = Msa()
    seqs: List[MsaSeq] = []
    residues: List[List[str]] = []
    active = 0
    for line in lines[1:]:
        if not line:
            active = 0
            continue
        if line[0].isspace():
            continue
        # name = chars up to first space (truncated at MSA_NAME_LEN-1)
        j = len(line)
        for i, ch in enumerate(line):
            if i == MSA_NAME_LEN - 1 or ch.isspace():
                j = i
                break
        name = line[:j]
        if active == len(seqs):
            sq = MsaSeq(name=name)
            sq.gaps = [0]
            seqs.append(sq)
            residues.append([])
        sq = seqs[active]
        _scan_residues(msa, sq, residues[active], line[j:])
        active += 1
    for sq, res in zip(seqs, residues):
        sq.seq = "".join(res)
        sq.len = len(sq.seq)
    msa.sequences = seqs
    return msa


def read_msf_lines(lines: List[str]) -> Msa:
    msa = Msa()
    seqs: List[MsaSeq] = []
    residues: List[List[str]] = []
    li = 0
    for nl, line in enumerate(lines):
        li = nl + 1
        if "//" in line:
            break
        if "Name:" in line and "Len:" in line:
            p = line[line.index("Name:") + 5:].lstrip()
            j = len(p)
            for i, ch in enumerate(p):
                if i == MSA_NAME_LEN - 1 or ch.isspace():
                    j = i
                    break
            sq = MsaSeq(name=p[:j])
            sq.gaps = [0]
            seqs.append(sq)
            residues.append([])
    active = 0
    for line in lines[li:]:
        if not line:
            active = 0
            continue
        if line[0].isspace():
            continue
        sq = seqs[active]
        _scan_residues(msa, sq, residues[active], line[len(sq.name):])
        active += 1
    for sq, res in zip(seqs, residues):
        sq.seq = "".join(res)
        sq.len = len(sq.seq)
    msa.sequences = seqs
    return msa


def read_stockholm_lines(lines: List[str]) -> Msa:
    """Stockholm 1.0 reader (sequence lines + multi-block continuation;
    #= annotation lines are skipped, // terminates).  The reference has
    no Stockholm reader; the writer lives in kalign_tpu_torch/io.py."""
    msa = Msa()
    order: List[str] = []
    parts = {}
    for line in lines:
        if line.startswith("//"):
            break
        if not line or line.startswith("#"):
            continue
        bits = line.split(None, 1)
        if len(bits) != 2:
            continue
        name, chunk = bits[0], bits[1].replace(" ", "")
        if name not in parts:
            parts[name] = []
            order.append(name)
        parts[name].append(chunk)
    if not order:
        raise ValueError("No sequences were found in the input.")
    for name in order:
        sq = MsaSeq(name=name[:MSA_NAME_LEN - 1])
        sq.gaps = [0]
        residues: List[str] = []
        _scan_residues(msa, sq, residues, "".join(parts[name]))
        sq.seq = "".join(residues)
        sq.len = len(sq.seq)
        msa.sequences.append(sq)
    return msa


def read_alignment_text(text: str) -> Msa:
    lines = _clean_lines(text)
    if not lines or (len(lines[0]) == 0):
        raise ValueError("No sequences were found in the input.")
    fmt = detect_format(lines)
    if fmt == FORMAT_FA:
        msa = read_fasta_lines(lines)
    elif fmt == FORMAT_MSF:
        msa = read_msf_lines(lines)
    elif fmt == FORMAT_CLU:
        msa = read_clu_lines(lines)
    elif fmt == FORMAT_STO:
        msa = read_stockholm_lines(lines)
    else:
        raise ValueError("Could not detect input format.")
    msa.detect_alphabet()
    msa.detect_aligned()
    msa.set_sip_nsip()
    return msa


def read_alignment(path: Optional[str]) -> Msa:
    import sys
    if path is None or path == "-":
        text = sys.stdin.read()
    else:
        with open(path, "r") as fh:
            text = fh.read()
    return read_alignment_text(text)


def read_inputs(paths: List[Optional[str]]) -> Msa:
    """Read and merge multiple input files (msa_io.c:160-165)."""
    out: Optional[Msa] = None
    for p in paths:
        m = read_alignment(p)
        if out is None:
            out = m
        else:
            if out.biotype != m.biotype:
                raise ValueError("Input alignments have different alphabets")
            out.sequences.extend(m.sequences)
            out.letter_freq += m.letter_freq
            out.detect_alphabet()
            out.detect_aligned()
            out.set_sip_nsip()
    if out is None or out.numseq < 2:
        raise ValueError("Fewer than 2 sequences found in the input files.")
    return out


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------

def write_fasta(msa: Msa) -> str:
    out = []
    for sq in msa.sequences:
        out.append(f">{sq.name}\n")
        row = sq.seq
        for start in range(0, len(row), 60):
            out.append(row[start:start + 60])
            out.append("\n")
        if len(row) == 0:
            pass
    return "".join(out)


def _blocked_rows(msa: Msa) -> List[str]:
    """Sequence block lines shared by CLU and MSF writers: rows of
    `name + padding-to-(max_name+5) + 60 residues`, grouped into blocks
    with a blank separator line after each block."""
    max_name = max(len(sq.name[:MSA_NAME_LEN]) for sq in msa.sequences)
    aln_len = msa.alnlen
    entries = []  # (block, seq_id, line)
    for i, sq in enumerate(msa.sequences):
        f = 0
        block = 0
        while True:
            chunk = sq.seq[f:f + 60]
            f += len(chunk)
            line = sq.name[:MSA_NAME_LEN].ljust(max_name + 5) + chunk
            entries.append((block, i, line))
            if i == 0:
                entries.append((block, msa.numseq, "\n"))
            block += 1
            if f == aln_len:
                break
    entries.sort(key=lambda e: (e[0], e[1]))
    return [e[2] for e in entries]


def write_clu(msa: Msa) -> str:
    out = [f"Kalign ({KALIGN_COMPAT_VERSION}) multiple sequence alignment\n", "\n"]
    for line in _blocked_rows(msa):
        out.append(line + "\n")
    return "".join(out)


def write_msf(msa: Msa, outfile: Optional[str] = None) -> str:
    max_name = max(len(sq.name[:MSA_NAME_LEN]) for sq in msa.sequences)
    aln_len = msa.alnlen
    # Reference quirk (msa_io.c:941-949,978): msa->L holds the alphabet
    # SIZE; AA header only for 21 (default protein) or 13 (reduced), and
    # Type 'P' only for 21.  After alignment protein MSAs carry L=23, so
    # the reference emits !!NA / Type N — reproduced for parity.
    is_protein = msa.L in (21, 13)
    header_type = "AA" if is_protein else "NA"
    date = time.strftime("%B %d, %Y %H:%M", time.localtime())
    basename = "stdout" if not outfile else outfile.rsplit("/", 1)[-1]
    # reference: MSF length field is sequences[0]->len (pre-finalise length
    # in the header "MSF:" but alnlen in Name: lines? both use aln_len set
    # from sequences[0]->len at msa_io.c:904)
    hdr_len = msa.sequences[0].len
    mult = 0
    for sq in msa.sequences:
        mult = (mult + gcg_checksum(sq.seq[:sq.len])) % 10000
    out = [f"!!{header_type}_MULTIPLE_ALIGNMENT 1.0\n", "\n"]
    out.append(f" {basename}  MSF: {hdr_len}  Type: {'P' if msa.L == 21 else 'N'}  "
               f"{date}  Check: {mult}  ..\n")
    out.append("\n")
    for sq in msa.sequences:
        name = sq.name[:MSA_NAME_LEN]
        out.append(f" Name: {name:<{max_name}.{max_name}}  Len:  {hdr_len:5d}  "
                   f"Check: {gcg_checksum(sq.seq[:sq.len]):4d}  Weight: 1.00\n")
    out.append("\n//\n\n")
    for line in _blocked_rows(msa):
        out.append(line + "\n")
    return "".join(out)


def format_alignment(msa: Msa, fmt: Optional[str] = None, outfile: Optional[str] = None) -> str:
    if fmt is None:
        fmt = "fasta"
    if "msf" in fmt:
        return write_msf(msa, outfile)
    if "clu" in fmt:
        return write_clu(msa)
    if "fa" in fmt:
        return write_fasta(msa)
    if "sto" in fmt:
        import io as _io
        from kalign_tpu_torch.io import write_stockholm
        buf = _io.StringIO()
        conf = [sq.confidence for sq in msa.sequences]
        write_stockholm([sq.seq for sq in msa.sequences], buf,
                        ids=[sq.name for sq in msa.sequences],
                        column_confidence=msa.col_confidence,
                        residue_confidence=conf
                        if any(c is not None for c in conf) else None)
        return buf.getvalue()
    raise ValueError(f"Format {fmt} not recognized.")


def write_alignment_file(msa: Msa, outfile: Optional[str], fmt: Optional[str] = None):
    text = format_alignment(msa, fmt, outfile)
    if outfile is None or outfile == "-":
        import sys
        sys.stdout.write(text)
    else:
        with open(outfile, "w") as fh:
            fh.write(text)
