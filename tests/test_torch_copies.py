"""Verbatim-copy guard: the port's copied host code equals the reference.

The port carries copies of the reference's host code whose bodies are
unchanged and whose imports point into the port.  With import statements
stripped, each copied module or definition must equal its counterpart in
``falcon_unzip_tpu`` line for line; the native IO library's Makefile and
C++ sources are byte-equal.
"""
import ast
import os

import pytest

import falcon_unzip_tpu
import falcon_unzip_tpu_torch

REF = os.path.dirname(falcon_unzip_tpu.__file__)
PORT = os.path.dirname(falcon_unzip_tpu_torch.__file__)

MODULES = ["coords.py", "models/unzipper.py", "io/overlaps.py",
           "models/dedup.py", "seq.py", "config.py", "io/fasta.py",
           "io/serialize.py", "io/ingest.py", "io/gfa.py", "io/native.py",
           "oracle/__init__.py", "oracle/align.py", "oracle/phasing.py",
           "oracle/hmm.py", "oracle/consensus.py", "graph/__init__.py",
           "graph/string_graph.py", "ops/kmer_index.py",
           "parallel/__init__.py", "parallel/checkpoint.py",
           "parallel/dataflow.py", "utils/metrics.py", "utils/simulate.py",
           "io/bamlite.py", "cli/compat.py"]

# the native IO library's build and sources, byte for byte
NATIVE = ["native/Makefile", "native/src/fastx.cpp", "native/src/bam.cpp"]

DEFS = {
    "ops/banded_align.py": [
        "MOVE_DIAG", "_round128", "build_schedule", "prepare_batch",
        "moves_forward", "unpack_moves2", "moves_to_tags_vec",
        "anchor_trim"],
    "models/aligner.py": [
        "AlnSet", "AlignerConfig", "clip_query_overhang", "LongAln",
        "align_long_queries", "_bucket", "_gather_rows", "_t_bucket"],
    "models/overlapper.py": [
        "OverlapSet", "OverlapperConfig", "PreadOverlapper._seq_pools",
        "PreadOverlapper._candidates", "_bucket", "_t_bucket"],
    "ops/association.py": ["assign_reads"],
    "ops/pileup.py": ["pileup_host", "het_call_host"],
    "models/phaser.py": [
        "_bucket", "ContigPhasing", "flat_delta0_tags", "phased_reads_table",
        "_g_ladder", "_prep_contig", "_group_chunks", "_het_filter_tags",
        "_sparse_block_votes"],
    "ops/pairhmm.py": ["params_vector"],
    "ops/arrow.py": ["_round_up", "ArrowSplicer._shapes",
                     "ArrowSplicer._pick_chunk"],
    "ops/consensus.py": [
        "_masks", "compact_masks", "consensus_from_votes",
        "consensus_with_map", "vote_matrix"],
    "models/polisher.py": [
        "_round128", "PolisherConfig", "_WinState", "PolishedContig",
        "window_read_segments", "window_votes", "TIER_PHRED", "TIER_EDGES",
        "LOWQ_TIER", "tier_table", "phred_to_tiers",
        "Polisher._vote_consensus", "Polisher._candidates",
        "Polisher._prep_windows", "Polisher._refine_windows",
        "Polisher._refine_windows_reforward", "Polisher._score_pairs",
        "Polisher._stitch_contig", "Polisher.polish_contig",
        "Polisher.polish_all", "QV_CAP", "_QV_TABLE", "_QV_TABLE_N",
        "_qv_table", "QV_TEMPLATE", "_qv_from_votes", "_stitch"],
    "pipeline/quiver.py": ["_phase_route_mask", "_emit"],
    "models/consensus.py": ["ConsensusConfig", "_bucket"],
    "utils/profiling.py": ["StageTimer"],
    "parallel/distributed.py": ["pack_arrays", "unpack_arrays"],
    "io/bamlite.py": [
        "BGZF_EOF", "_NIB2CODE", "_CODE2NIB", "CIGAR_OPS", "bgzf_decompress",
        "bgzf_compress", "BamRecord", "BamFile", "read_bam", "write_bam",
        "iter_bam", "select_reads_by_contig"],
    "cli/__init__.py": [
        "_cmd_gen_gfa", "_cmd_readmap", "_parse_phased_reads",
        "_cmd_select_reads", "_cmd_bam2m4"],
}


def _names(node):
    if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
        return [node.name]
    if isinstance(node, ast.Assign):
        return [e.id for t in node.targets
                for e in (t.elts if isinstance(t, ast.Tuple) else [t])
                if isinstance(e, ast.Name)]
    return []


def _text(path, name=None):
    """Source of the module (or of one top-level / Class.method
    definition) with every import statement removed."""
    with open(path) as fh:
        src = fh.read()
    lines = src.splitlines()
    tree = ast.parse(src)
    lo, hi = 1, len(lines)
    scope = tree
    if name is not None:
        for part in name.split("."):
            node = next(n for n in scope.body if part in _names(n))
            scope = node
        lo = min([node.lineno] + [d.lineno for d in
                                  getattr(node, "decorator_list", [])])
        hi = node.end_lineno
    drop = set()
    for n in ast.walk(scope):
        if isinstance(n, (ast.Import, ast.ImportFrom)):
            drop.update(range(n.lineno, n.end_lineno + 1))
    return [ln for k, ln in enumerate(lines[lo - 1:hi], start=lo)
            if k not in drop]


@pytest.mark.parametrize("rel", MODULES)
def test_copied_module_is_verbatim(rel):
    assert _text(os.path.join(PORT, rel)) == _text(os.path.join(REF, rel))


@pytest.mark.parametrize("rel,name", [(rel, nm) for rel, names in
                                      DEFS.items() for nm in names])
def test_copied_definition_is_verbatim(rel, name):
    assert (_text(os.path.join(PORT, rel), name)
            == _text(os.path.join(REF, rel), name))


@pytest.mark.parametrize("rel", NATIVE)
def test_native_source_is_byte_equal(rel):
    with open(os.path.join(PORT, rel), "rb") as a, \
            open(os.path.join(REF, rel), "rb") as b:
        assert a.read() == b.read()

