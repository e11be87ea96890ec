"""User-facing alignment I/O helpers — a copy of kalign_tpu/io.py, which
mirrors the reference python-kalign ``kalign.io`` module (read_fasta /
read_sequences / write_fasta / write_clustal / write_stockholm /
write_phylip), built on this package's own parsers so Biopython is
optional.  core/io.py's "sto" format goes through write_stockholm.
"""

from pathlib import Path
from typing import List, Optional, TextIO, Tuple, Union

from kalign_tpu_torch.core import io as _cio


def read_fasta(path: Union[str, Path]) -> List[str]:
    """Read a FASTA file, returning sequences only."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"File not found: {path}")
    msa = _cio.read_alignment(str(path))
    return [sq.seq for sq in msa.sequences]


def read_sequences(path: Union[str, Path],
                   format: str = "auto") -> Tuple[List[str], List[str]]:
    """Read sequences + IDs.  FASTA/MSF/Clustal parse natively; other
    formats (genbank/embl/swiss) go through Biopython when available."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"File not found: {path}")
    ext = path.suffix.lower()
    if format == "auto" and ext in (".gb", ".gbk", ".embl", ".swiss"):
        format = {".gb": "genbank", ".gbk": "genbank", ".embl": "embl",
                  ".swiss": "swiss-prot"}[ext]
    if format not in ("auto", "fasta", "msf", "clustal"):
        from Bio import SeqIO
        with open(path) as handle:
            records = list(SeqIO.parse(handle, format))
        return [str(r.seq) for r in records], [r.id for r in records]
    msa = _cio.read_alignment(str(path))
    return ([sq.seq for sq in msa.sequences],
            [sq.name.split()[0] if sq.name.split() else sq.name
             for sq in msa.sequences])


def _write(path, text: str):
    if hasattr(path, "write"):
        path.write(text)
    else:
        with open(path, "w") as fh:
            fh.write(text)


def _check(alignment, ids):
    if not alignment:
        raise ValueError("Empty alignment provided")
    if ids is None:
        ids = [f"seq{i}" for i in range(len(alignment))]
    elif len(ids) != len(alignment):
        raise ValueError(
            f"Number of IDs ({len(ids)}) must match alignment length "
            f"({len(alignment)})")
    return ids


def write_fasta(alignment: List[str], path, ids: Optional[List[str]] = None,
                line_length: int = 80) -> None:
    ids = _check(alignment, ids)
    out = []
    for seq_id, seq in zip(ids, alignment):
        out.append(f">{seq_id}\n")
        for i in range(0, len(seq), line_length):
            out.append(seq[i:i + line_length] + "\n")
    _write(path, "".join(out))


def write_clustal(alignment: List[str], path,
                  ids: Optional[List[str]] = None) -> None:
    ids = _check(alignment, ids)
    width = max(len(i) for i in ids) + 3
    out = ["CLUSTAL X (kalign_tpu) multiple sequence alignment\n", "\n", "\n"]
    alnlen = len(alignment[0])
    for start in range(0, alnlen, 60):
        for seq_id, seq in zip(ids, alignment):
            out.append(f"{seq_id:<{width}}{seq[start:start + 60]}\n")
        out.append("\n")
    _write(path, "".join(out))


def _conf_to_pp_char(conf: float) -> str:
    if conf >= 0.95:
        return "*"
    return str(int(conf * 10))


def write_stockholm(alignment: List[str], path,
                    ids: Optional[List[str]] = None,
                    column_confidence=None,
                    residue_confidence=None) -> None:
    """Stockholm writer with HMMER-style PP confidence annotations
    (#=GR <name> PP / #=GC PP_cons), matching python-kalign io.py:246-346."""
    ids = _check(alignment, ids)
    out = ["# STOCKHOLM 1.0\n"]
    max_id = max(len(i) for i in ids)
    pp_label_len = max(max_id, len("PP_cons"))
    for idx, (seq_id, seq) in enumerate(zip(ids, alignment)):
        out.append(f"{seq_id:<{max_id}}   {seq}\n")
        if residue_confidence is not None and idx < len(residue_confidence):
            rc = residue_confidence[idx]
            pp = []
            for ch, conf in zip(seq, rc):
                pp.append("." if ch in "-." else _conf_to_pp_char(conf))
            out.append(f"#=GR {seq_id:<{max_id}} PP {''.join(pp)}\n")
    if column_confidence is not None:
        pp_cons = "".join(_conf_to_pp_char(c) for c in column_confidence)
        out.append(f"#=GC {'PP_cons':<{pp_label_len}}   {pp_cons}\n")
    out.append("//\n")
    _write(path, "".join(out))


def write_phylip(alignment: List[str], path,
                 ids: Optional[List[str]] = None,
                 interleaved: bool = False) -> None:
    ids = _check(alignment, ids)
    n = len(alignment)
    alnlen = len(alignment[0])
    out = [f" {n} {alnlen}\n"]
    if interleaved:
        first = True
        for start in range(0, alnlen, 60):
            for seq_id, seq in zip(ids, alignment):
                label = f"{seq_id[:10]:<10}" if first else ""
                out.append(f"{label}{seq[start:start + 60]}\n")
            out.append("\n")
            first = False
    else:
        for seq_id, seq in zip(ids, alignment):
            out.append(f"{seq_id[:10]:<10}{seq}\n")
    _write(path, "".join(out))
