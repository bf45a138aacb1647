"""Entry alignment by event id for file-vs-file comparisons
(counterpart of ubresnet_tpu/parity/align.py).

The reference carries (run, subrun, event) ids end-to-end precisely so
score files can be matched to truth/partner files by event identity
rather than file position (deploy/run_ubresnet_precropped.py:163-168
re-emits the input's rse into the output IOManager). Comparing by raw
index silently mis-pairs entries whenever one file is reordered,
filtered, or merged; everything in parity/ therefore pairs entries
through `align_entries`.
"""
from __future__ import annotations

from typing import List, Tuple


def _rse_index(reader) -> dict:
    idx = {}
    for i in range(len(reader)):
        idx.setdefault(reader.rse(i), []).append(i)
    return idx


def align_entries(ra, rb, n_entries=None) -> List[Tuple[int, int]]:
    """Pair entries of two EventFileReaders by (run, subrun, event).

    Returns [(ia, ib), ...] in file-A order. Falls back to positional
    pairing when either file's ids are degenerate (all identical —
    e.g. synthetic files written without set_id), since ids carry no
    information there. Raises ValueError with a diagnostic listing the
    unmatched ids when the id sets genuinely disagree.
    """
    ia = _rse_index(ra)
    ib = _rse_index(rb)
    degenerate = len(ia) <= 1 or len(ib) <= 1
    dup = any(len(v) > 1 for v in ia.values()) or any(
        len(v) > 1 for v in ib.values()
    )
    if degenerate or dup:
        # ids are non-unique: positional is the only consistent pairing
        pairs = [(i, i) for i in range(min(len(ra), len(rb)))]
        return pairs[:n_entries] if n_entries is not None else pairs

    missing = [r for r in ia if r not in ib]
    if missing:
        extra = [r for r in ib if r not in ia]
        raise ValueError(
            f"entry alignment failed: {len(missing)} event ids in "
            f"{getattr(ra, 'path', 'A')} have no match in "
            f"{getattr(rb, 'path', 'B')} — first missing "
            f"(run,subrun,event): {missing[:5]}"
            + (f"; first unmatched on the other side: {extra[:5]}"
               if extra else "")
        )
    # file-A order (as documented): n_entries then selects "the first
    # k entries of file A", not the k numerically-smallest event ids
    pairs = sorted(
        ((ia[r][0], ib[r][0]) for r in ia), key=lambda p: p[0]
    )
    return pairs[:n_entries] if n_entries is not None else pairs
