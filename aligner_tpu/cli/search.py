"""``aligner-search`` — one query vs a FASTA database, top-k hits.

The batched one-vs-many path (BASELINE config #4): scores for the whole
database come from bucketed scores-only launches; alignments are computed
only for the winners.
"""

from __future__ import annotations

import argparse
import sys

from ..alphabet import DNA, Protein
from ..backend import ENGINES
from ..errors import ValidationError
from ..io import read_fasta_file
from ..matrices import blosum50, blosum62
from ..io.matrix_io import matrix_from_csv
from ..search import search_database


def load_matrix(spec: str):
    """"blosum62", "blosum50", or a path to a space-delimited matrix."""
    if spec == "blosum62":
        return blosum62()
    if spec == "blosum50":
        return blosum50()
    with open(spec) as fh:
        return matrix_from_csv(fh.read())


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="aligner-search", description=__doc__)
    ap.add_argument("-q", "--query", required=True,
                    help="FASTA with the query (first record used)")
    ap.add_argument("-i", "--database", required=True, help="FASTA database")
    ap.add_argument("-k", "--top", type=int, default=10)
    ap.add_argument("-d", "--deletions", type=float, default=11.0)
    ap.add_argument("-e", "--extension", type=float, default=2.0)
    ap.add_argument("-m", "--matrix", default="blosum62",
                    help="blosum62 | blosum50 | path to matrix file")
    ap.add_argument("--dna", action="store_true", help="DNA alphabet")
    ap.add_argument("--global", dest="global_", action="store_true")
    ap.add_argument("--no-alignments", action="store_true",
                    help="scores only (faster)")
    ap.add_argument("--backend", default=None, choices=ENGINES)
    args = ap.parse_args(argv)

    alphabet = DNA if args.dna else Protein
    query = read_fasta_file(args.query)[0]
    # read_fasta raises on zero records, and search_database re-checks
    # emptiness — no guard needed here
    db = read_fasta_file(args.database)

    hits = search_database(
        query.seq.decode(),
        [r.seq.decode() for r in db],
        load_matrix(args.matrix),
        args.deletions,
        args.extension,
        k=args.top,
        names=[r.id for r in db],
        alphabet=alphabet,
        backend=args.backend,
        mode="global" if args.global_ else "local",
        with_alignments=not args.no_alignments,
    )
    for rank, h in enumerate(hits, 1):
        print(f"{rank}\t{h.name}\t{h.score}")
        if h.query_aligned is not None:
            print(f"\tQ {alphabet.decode(h.query_aligned)}")
            print(f"\tT {alphabet.decode(h.target_aligned)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
