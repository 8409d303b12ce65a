"""GFA-1 emitters for the unzipped assembly and its string graph.

Role parity: [U] falcon_unzip/mains/unzip_gen_gfa_v1.py — GFA-1 of
p_ctg + h_ctg with edges (SURVEY.md §2a GFA row).  Two views:

- ``write_gfa``    : assembly view — contig S lines, haplotig placement
  L lines, plus graph-adjacency L lines between contigs whose tiling
  paths meet at a shared string-graph junction node.
- ``write_sg_gfa`` : string-graph view — one S line per read, one L line
  per dovetail edge (mirror pairs emitted once; a GFA link is implicitly
  bidirectional), loadable in any GFA validator/viewer.
"""
from __future__ import annotations

import os

from ..graph.string_graph import mirror, node_orient, node_read
from ..seq import decode


def write_gfa(path: str, p_ctg, h_ctg, placements=None,
              include_seq: bool = True, p_paths=None, graph=None) -> None:
    """p_ctg: [(name, seq, reads)], h_ctg: list[Haplotig].

    p_paths + graph (optional): node paths aligned with p_ctg and the
    reduced StringGraph — emits L lines between contigs adjacent in the
    graph (an edge from one contig's terminal node into another's first
    node), the graph-edge parity the round-1 emitter lacked
    (VERDICT.md missing #8).
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("H\tVN:Z:1.0\n")
        for name, seq, _ in p_ctg:
            s = decode(seq) if include_seq else "*"
            fh.write(f"S\t{name}\t{s}\tLN:i:{len(seq)}\n")
        for h in h_ctg:
            s = decode(h.seq) if include_seq else "*"
            fh.write(f"S\t{h.name}\t{s}\tLN:i:{len(h.seq)}\n")
        # placement edges: haplotig attaches to its primary at p_start/p_end
        for h in h_ctg:
            fh.write(f"L\t{h.primary}\t+\t{h.name}\t+\t0M\t"
                     f"SP:i:{h.p_start}\tEP:i:{h.p_end}\n")
        # graph adjacency between contigs (tiling-path junctions)
        if p_paths and graph is not None:
            head_of = {}   # first node -> (ctg, idx)
            for (name, _s, _r), pth in zip(p_ctg, p_paths):
                if pth:
                    head_of[pth[0]] = name
            for (name, _s, _r), pth in zip(p_ctg, p_paths):
                if not pth:
                    continue
                tail = pth[-1]
                for v in graph.edges.get(tail, ()):
                    nxt = head_of.get(v)
                    if nxt is not None and nxt != name:
                        ov = graph.edges[tail][v].ov_len
                        fh.write(f"L\t{name}\t+\t{nxt}\t+\t{ov}M\n")


def write_sg_gfa(path: str, graph, read_lens, names=None,
                 reads=None) -> None:
    """String graph as GFA-1: S per non-contained read, L per edge.

    graph: StringGraph (post-reduction); read_lens: (n_reads,) lengths;
    names: optional read names; reads: optional SeqBatch to inline
    sequences (omitted -> S lines carry '*' + LN tag).
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def nm(r: int) -> str:
        return names[r] if names else f"{r:09d}"

    used: set[int] = set()
    lines = []
    for u in sorted(graph.edges):
        for v in sorted(graph.edges[u]):
            # one line per mirror pair: L A+ B+ duplicates L B- A-
            if (mirror(v), mirror(u)) < (u, v):
                continue
            e = graph.edges[u][v]
            ou = "+" if node_orient(u) == 0 else "-"
            ov_ = "+" if node_orient(v) == 0 else "-"
            lines.append(f"L\t{nm(node_read(u))}\t{ou}\t"
                         f"{nm(node_read(v))}\t{ov_}\t{e.ov_len}M\n")
            used.add(node_read(u))
            used.add(node_read(v))
    with open(path, "w") as fh:
        fh.write("H\tVN:Z:1.0\n")
        for r in sorted(used):
            s = reads.to_str(r) if reads is not None else "*"
            fh.write(f"S\t{nm(r)}\t{s}\tLN:i:{int(read_lens[r])}\n")
        fh.writelines(lines)


def write_ctg_paths(path: str, p_ctg, p_paths, graph,
                    names=None) -> None:
    """ctg_paths-role records: per primary contig, its tiling path.

    Role parity: [U] phased_ovlp_to_graph ``ctg_paths`` (SURVEY.md §2a):
    (ctg_id, type, start_node, end_node, length, n_edges, path).
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def node_str(nd: int) -> str:
        r = node_read(nd)
        n = names[r] if names else f"{r:09d}"
        return f"{n}:{'E' if node_orient(nd) == 0 else 'B'}"

    with open(path, "w") as fh:
        for (name, seq, _reads), pth in zip(p_ctg, p_paths or []):
            if not pth:
                continue
            fh.write(" ".join([
                name, "ctg_linear", node_str(pth[0]), node_str(pth[-1]),
                str(len(seq)), str(len(pth) - 1),
                "~".join(node_str(n) for n in pth)]) + "\n")
