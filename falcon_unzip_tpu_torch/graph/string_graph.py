"""String graph over pread overlaps: Myers construction + reduction.

Role parity: [U] falcon_unzip/mains/phased_ovlp_to_graph.py (falcon-kit's
ovlp_to_graph algorithm with phase labels: containment removal, dovetail
edge construction, transitive reduction, spur trimming, unitig
identification — SURVEY.md §2a).  Host-side by design (SURVEY.md §7 hard
part (d)): the graph is tiny next to the alignment/consensus tensors and
stays off the device hot path.

Node convention: node = read_id * 2 + orient (orient 1 = reverse
complement).  Every edge u→v has a mirror edge mirror(v)→mirror(u);
mirror((r, o)) = (r, o ^ 1).  An edge u→v means "a walk that ends with
seq(u) continues into the un-overlapped suffix of seq(v)"; its extension
is seq(v)[v_ov_end:].
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np


def node(read: int, orient: int) -> int:
    return read * 2 + orient


def node_read(n: int) -> int:
    return n >> 1


def node_orient(n: int) -> int:
    return n & 1


def mirror(n: int) -> int:
    return n ^ 1


@dataclasses.dataclass
class SGEdge:
    src: int
    dst: int
    ext_start: int   # extension = seq(dst)[ext_start:]
    ov_len: int      # overlap length supporting this edge
    dist: int        # edit distance of the supporting overlap

    @property
    def ext_len_key(self):
        return self.ext_start


class StringGraph:
    def __init__(self, read_lens: np.ndarray):
        self.read_lens = np.asarray(read_lens)
        self.n_reads = len(read_lens)
        self.contained = np.zeros(self.n_reads, dtype=bool)
        self.edges: dict[int, dict[int, SGEdge]] = defaultdict(dict)
        self.in_nodes: dict[int, set[int]] = defaultdict(set)

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_overlaps(ovl, read_lens: np.ndarray, fuzz: int = 60,
                      keep_mask: np.ndarray | None = None) -> "StringGraph":
        """Build from an OverlapSet (coordinates per models.overlapper).

        keep_mask: optional (O,) bool — overlaps to use (after phase/quality
        filtering); others ignored.
        """
        g = StringGraph(read_lens)
        O = len(ovl)
        keep = np.ones(O, bool) if keep_mask is None else keep_mask

        # pass 1: containment
        for o in range(O):
            if not keep[o]:
                continue
            a, b = int(ovl.a_id[o]), int(ovl.b_id[o])
            la, lb = int(ovl.a_len[o]), int(ovl.b_len[o])
            a_l = ovl.a_start[o] < fuzz
            a_r = ovl.a_end[o] > la - fuzz
            b_l = ovl.b_start[o] < fuzz
            b_r = ovl.b_end[o] > lb - fuzz
            if b_l and b_r:
                g.contained[b] = True
            elif a_l and a_r:
                g.contained[a] = True

        # pass 2: dovetail edges between non-contained reads
        for o in range(O):
            if not keep[o]:
                continue
            a, b = int(ovl.a_id[o]), int(ovl.b_id[o])
            if g.contained[a] or g.contained[b]:
                continue
            s = int(ovl.strand[o])
            la, lb = int(ovl.a_len[o]), int(ovl.b_len[o])
            a_s, a_e = int(ovl.a_start[o]), int(ovl.a_end[o])
            b_s, b_e = int(ovl.b_start[o]), int(ovl.b_end[o])
            ov_len = a_e - a_s
            dist = int(ovl.dist[o])
            a_l, a_r = a_s < fuzz, a_e > la - fuzz
            b_l, b_r = b_s < fuzz, b_e > lb - fuzz
            if (b_l and b_r) or (a_l and a_r):
                continue
            if a_r and b_l:
                # suffix(a fwd) ~ prefix(b in orientation s)
                g._add_edge(node(a, 0), node(b, s), b_e, ov_len, dist)
                g._add_edge(node(b, s ^ 1), node(a, 1), la - a_s, ov_len, dist)
            elif a_l and b_r:
                # prefix(a fwd) ~ suffix(b in orientation s)
                g._add_edge(node(b, s), node(a, 0), a_e, ov_len, dist)
                g._add_edge(node(a, 1), node(b, s ^ 1), lb - b_s, ov_len, dist)
        return g

    def _add_edge(self, u: int, v: int, ext_start: int, ov_len: int,
                  dist: int):
        cur = self.edges[u].get(v)
        if cur is None or ov_len > cur.ov_len:
            self.edges[u][v] = SGEdge(u, v, ext_start, ov_len, dist)
            self.in_nodes[v].add(u)

    # -- reductions --------------------------------------------------------

    def ext_len(self, e: SGEdge) -> int:
        return int(self.read_lens[node_read(e.dst)]) - e.ext_start

    def transitive_reduction(self, fuzz: int = 100):
        """Myers 2005 transitive edge marking, deterministic order."""
        reduced: set[tuple[int, int]] = set()
        for v in sorted(self.edges):
            out = sorted(self.edges[v].values(),
                         key=lambda e: (self.ext_len(e), e.dst))
            if not out:
                continue
            longest = self.ext_len(out[-1]) + fuzz
            for e_vw in out:
                w = e_vw.dst
                lw = self.ext_len(e_vw)
                for e_wx in sorted(self.edges.get(w, {}).values(),
                                   key=lambda e: (self.ext_len(e), e.dst)):
                    x = e_wx.dst
                    lx = lw + self.ext_len(e_wx)
                    if lx > longest:
                        break
                    e_vx = self.edges[v].get(x)
                    if e_vx is not None and abs(self.ext_len(e_vx) - lx) < fuzz:
                        reduced.add((v, x))
        for (v, x) in reduced:
            # keep the graph mirror-symmetric
            for (p, q) in ((v, x), (mirror(x), mirror(v))):
                if q in self.edges.get(p, {}):
                    del self.edges[p][q]
                    self.in_nodes[q].discard(p)

    @staticmethod
    def find_chimers(ovl, keep: np.ndarray, fuzz: int = 60) -> np.ndarray:
        """Reads whose kept overlaps never anchor one of their ends.

        Role parity: falcon's chimer classification inside ovlp_to_graph
        ([U] phased_ovlp_to_graph, SURVEY.md §2a: "chimer/spur
        filtering").  A chimeric junction read joins two unrelated loci,
        so real neighbors only overlap its halves: it accumulates
        overlaps yet neither pile reaches one of its ends.  Interior
        contig reads are end-anchored on both sides; true contig-terminal
        reads have NO overlap on the outside — they show one anchored
        end + no interior-only evidence and are kept.

        Returns a bool (n_reads,) chimer mask.  (The coverage min_cov
        filter drops these reads' overlaps when enabled; this graph-level
        mask covers callers that ingest pre-filtered overlap files.)
        """
        n = int(max(ovl.a_id.max(initial=-1), ovl.b_id.max(initial=-1))) + 1
        left = np.zeros(n, bool)
        right = np.zeros(n, bool)
        interior = np.zeros(n, bool)
        has = np.zeros(n, bool)
        a_l = ovl.a_start < fuzz
        a_r = ovl.a_end > ovl.a_len - fuzz
        bm_l = ovl.b_start < fuzz
        bm_r = ovl.b_end > ovl.b_len - fuzz
        rc = ovl.strand == 1
        b_l = np.where(rc, bm_r, bm_l)
        b_r = np.where(rc, bm_l, bm_r)
        contain_a = a_l & a_r            # a contained in b
        contain_b = b_l & b_r            # b contained in a
        for rid, el, er, other_contained in (
                (ovl.a_id, a_l, a_r, contain_b),
                (ovl.b_id, b_l, b_r, contain_a)):
            left[rid[keep & el]] = True
            right[rid[keep & er]] = True
            # a contained partner buried in this read's middle is normal
            # for contig-terminal reads — only non-containment interior
            # overlaps are chimer evidence
            interior[rid[keep & ~el & ~er & ~other_contained]] = True
            has[rid[keep]] = True
        # chimer: has overlaps, an unanchored end, AND interior-only
        # evidence (something overlapped its middle without reaching out)
        return has & interior & ~(left & right)

    def remove_spurs(self, max_ext: int = 2):
        """Trim dead-end branches of <= max_ext edges hanging off junctions."""
        changed = True
        while changed:
            changed = False
            for v in list(self.edges):
                if self.edges[v]:
                    continue
                # v is a dead end; if its predecessors branch, drop edge(s)
                for u in list(self.in_nodes.get(v, ())):
                    if len(self.edges.get(u, {})) > 1:
                        del self.edges[u][v]
                        self.in_nodes[v].discard(u)
                        changed = True

    # -- queries -----------------------------------------------------------

    def out_degree(self, v: int) -> int:
        return len(self.edges.get(v, {}))

    def in_degree(self, v: int) -> int:
        return len(self.in_nodes.get(v, ()))

    def active_nodes(self):
        ns = set()
        for u, d in self.edges.items():
            if d:
                ns.add(u)
                ns.update(d)
        for r in range(self.n_reads):
            if not self.contained[r]:
                ns.add(node(r, 0))
                ns.add(node(r, 1))
        return sorted(ns)

    # -- intermediate record emission (sg_edges_list parity) ---------------

    def sg_edges_records(self, names: list[str] | None = None):
        """Edge records in a falcon sg_edges_list-like shape:
        (src, dst, ext_start, ext_len, ov_len, dist, flag) — flag 'G' for
        kept graph edges ([U] fc_phased_ovlp_to_graph output parity)."""
        def node_str(nd: int) -> str:
            r = node_read(nd)
            nm = names[r] if names else f"{r:09d}"
            return f"{nm}:{'E' if node_orient(nd) == 0 else 'B'}"

        out = []
        for u in sorted(self.edges):
            for v in sorted(self.edges[u]):
                e = self.edges[u][v]
                out.append((node_str(u), node_str(v), e.ext_start,
                            self.ext_len(e), e.ov_len, e.dist, "G"))
        return out

    def write_sg_edges(self, path: str,
                       names: list[str] | None = None) -> None:
        import os
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            for rec in self.sg_edges_records(names):
                fh.write(" ".join(str(x) for x in rec) + "\n")

    def _node_str(self, nd: int, names: list[str] | None = None) -> str:
        r = node_read(nd)
        nm = names[r] if names else f"{r:09d}"
        return f"{nm}:{'E' if node_orient(nd) == 0 else 'B'}"

    def utg_records(self, names: list[str] | None = None):
        """Unitig records in a falcon utg_data-like shape.

        Role parity: [U] phased_ovlp_to_graph's ``utg_data`` output
        (SURVEY.md §2a: "unitig/bubble identification, sg_edges_list,
        utg_data, ctg_paths").  One record per canonical maximal simple
        path: (start, via, end, type, length, n_edges, path) where
        length sums edge extensions and path joins the node strings with
        '~'.  Mirror duplicates are dropped (canonical = lexicographically
        smaller of path / mirrored-reversed path).
        """
        recs = []
        seen: set[tuple[int, ...]] = set()
        for path in self.unitigs():
            fwd = tuple(path)
            rev = tuple(mirror(n) for n in reversed(path))
            if min(fwd, rev) in seen:
                continue
            seen.add(min(fwd, rev))
            length = sum(self.ext_len(self.edges[u][v])
                         for u, v in zip(path, path[1:]))
            recs.append((
                self._node_str(path[0], names),
                self._node_str(path[1], names) if len(path) > 2 else "~",
                self._node_str(path[-1], names),
                "simple", length, len(path) - 1,
                "~".join(self._node_str(n, names) for n in path)))
        # bubble records ([U] utg_data "compound" rows): a branch whose
        # arms reconverge is one record naming every arm, so downstream
        # consumers see haplotype bubbles as graph objects, not just as
        # the haplotig walker's private state (SURVEY.md §2a phased
        # string graph row)
        seen_b: set[tuple[int, int]] = set()
        for src, dst, arms in self.bubbles():
            key = min((src, dst), (mirror(dst), mirror(src)))
            if key in seen_b:
                continue
            seen_b.add(key)
            arm_lens = [sum(self.ext_len(self.edges[u][v])
                            for u, v in zip(a, a[1:])) for a in arms]
            recs.append((
                self._node_str(src, names), "~",
                self._node_str(dst, names),
                "compound", max(arm_lens),
                sum(len(a) - 1 for a in arms),
                "|".join("~".join(self._node_str(n, names) for n in a)
                         for a in arms)))
        return recs

    def bubbles(self, max_steps: int = 64):
        """Simple bubbles: (src, dst, arms) where every out-branch of a
        junction node follows simple nodes to the SAME reconvergence
        junction.  Arms include both endpoints."""
        out = []
        for u in sorted(self.edges):
            if self.out_degree(u) < 2:
                continue
            arms = []
            ends = set()
            ok = True
            for v in sorted(self.edges[u]):
                arm = [u, v]
                steps = 0
                while (self.out_degree(arm[-1]) == 1
                       and self.in_degree(arm[-1]) == 1
                       and steps < max_steps):
                    arm.append(next(iter(self.edges[arm[-1]])))
                    steps += 1
                if steps >= max_steps or arm[-1] == u:
                    ok = False
                    break
                arms.append(arm)
                ends.add(arm[-1])
            if ok and len(ends) == 1 and len(arms) >= 2:
                dst = next(iter(ends))
                if self.in_degree(dst) == len(arms):
                    out.append((u, dst, arms))
        return out

    def write_utg_data(self, path: str,
                       names: list[str] | None = None) -> None:
        import os
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            for rec in self.utg_records(names):
                fh.write(" ".join(str(x) for x in rec) + "\n")

    # -- unitigs -----------------------------------------------------------

    def unitigs(self) -> list[list[int]]:
        """Maximal simple paths (node lists). Each unitig's mirror is also
        emitted (canonical filtering is the caller's concern)."""
        paths = []
        visited_edges: set[tuple[int, int]] = set()

        def is_simple_through(v: int) -> bool:
            return self.out_degree(v) == 1 and self.in_degree(v) == 1

        for u in sorted(self.edges):
            for v in sorted(self.edges[u]):
                if (u, v) in visited_edges:
                    continue
                # only start at a path head: u is a junction or a source
                if is_simple_through(u) and (u, v) == _only_edge(self, u):
                    prev = next(iter(self.in_nodes[u]))
                    if (prev, u) not in visited_edges and \
                            self.out_degree(prev) == 1:
                        continue  # will be reached from upstream
                path = [u, v]
                visited_edges.add((u, v))
                while is_simple_through(path[-1]):
                    nxt = next(iter(self.edges[path[-1]]))
                    if (path[-1], nxt) in visited_edges:
                        break
                    visited_edges.add((path[-1], nxt))
                    path.append(nxt)
                paths.append(path)
        return paths


def _only_edge(g: StringGraph, u: int):
    (v,) = g.edges[u].keys()
    return (u, v)
