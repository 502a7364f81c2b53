"""Parity checks against the committed reference goldens (tests/golden).

`tests/golden/<name>.dbg` is a junction list written by the reference
binary, and `<name>.seq|group|dot|gfa1|gfa2|fasta` are the reference
graphdump's renderings of it. The reference seeds its hash functions
from /dev/urandom, so its junction ids and signs change from run to run
and are never compared raw (SURVEY.md §5). Parity of our output is:

  - the same junction (chr, pos) list as the golden `.seq`, split into
    the same same-id groups, and a byte-identical `group` rendering
    (that format carries no ids);
  - our graphdump byte-identical to every golden rendering of the
    golden `.dbg`. GFA1's `UR:Z:` field names the FASTA path the dump
    was made from, which differs between checkouts, so it is normalised.

Each check returns a list of mismatch descriptions; empty means parity.
"""

from __future__ import annotations

import contextlib
import io
import os
import re

import numpy as np

from twopaco_tpu.io import junctions

GOLDEN_DIR = os.path.join(
    os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ),
    "tests",
    "golden",
)
FORMATS = ("seq", "group", "dot", "gfa1", "gfa2", "fasta")
_NEEDS_SEQ = ("gfa1", "gfa2", "fasta")
_UR_FIELD = re.compile(r"UR:Z:\S*")


def normalise_gfa(text: str) -> str:
    """Blank the path in every GFA `UR:Z:` field."""
    return _UR_FIELD.sub("UR:Z:", text)


def render(dbg: str, fmt: str, k: int, fasta: str) -> str:
    """graphdump `fmt` of `dbg` through the graphdump CLI, as text."""
    from twopaco_tpu.cli import graphdump

    argv = ["-f", fmt, "-k", str(k), dbg]
    if fmt in _NEEDS_SEQ:
        argv += ["-s", fasta]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = graphdump.main(argv)
    if rc != 0:
        raise RuntimeError(f"graphdump {' '.join(argv)} exited {rc}")
    return buf.getvalue()


def _groups(chrs, pos, ids) -> list:
    groups: dict[int, list] = {}
    for c, p, i in zip(chrs.tolist(), pos.tolist(), ids.tolist()):
        groups.setdefault(i, []).append((c, p))
    return sorted(groups.values())


def junction_parity(dbg: str, name: str) -> list[str]:
    """Our `dbg` against golden `<name>.seq` and `<name>.group`."""
    chrs, pos, ids = junctions.read_junctions(dbg)
    want = np.loadtxt(
        os.path.join(GOLDEN_DIR, f"{name}.seq"), dtype=np.int64, ndmin=2
    )
    if not (
        np.array_equal(chrs, want[:, 0]) and np.array_equal(pos, want[:, 1])
    ):
        return [f"{name}: junction positions differ"]
    problems = []
    if _groups(chrs, pos, ids) != _groups(want[:, 0], want[:, 1], want[:, 2]):
        problems.append(f"{name}: junction groups differ")
    with open(os.path.join(GOLDEN_DIR, f"{name}.group")) as fh:
        if render(dbg, "group", 0, "") != fh.read():
            problems.append(f"{name}: graphdump group differs")
    return problems


def graphdump_parity(name: str, k: int, fasta: str) -> list[str]:
    """Our graphdump of golden `<name>.dbg` against each golden rendering."""
    dbg = os.path.join(GOLDEN_DIR, f"{name}.dbg")
    problems = []
    for fmt in FORMATS:
        with open(os.path.join(GOLDEN_DIR, f"{name}.{fmt}")) as fh:
            want = fh.read()
        if normalise_gfa(render(dbg, fmt, k, fasta)) != normalise_gfa(want):
            problems.append(f"{name}: graphdump {fmt} differs")
    return problems


def first_difference(a: str, b: str) -> str | None:
    """None when files `a` and `b` hold the same bytes, else where they
    first differ."""
    with open(a, "rb") as fa, open(b, "rb") as fb:
        da, db = fa.read(), fb.read()
    if da == db:
        return None
    n = min(len(da), len(db))
    diff = np.flatnonzero(
        np.frombuffer(da, np.uint8, n) != np.frombuffer(db, np.uint8, n)
    )
    at = int(diff[0]) if diff.size else n
    return f"{a} and {b} differ at byte {at} (sizes {len(da)}, {len(db)})"
