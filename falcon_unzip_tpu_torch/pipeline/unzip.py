"""3-unzip pipeline driver (the fc_unzip.py role).

Port of ``falcon_unzip_tpu.pipeline.unzip``.  Same stages, Stage
markers, resume, persisted AlnSet and overlap prefetch as the reference;
every device step runs on ``device``.  ``cfg.mesh.n_devices > 1`` (or
several visible cards) phases each contig over a ('data', 'window') mesh
(``parallel.sharding.ShardedPhaseOps``).  ``cfg.mesh.multihost`` joins a
world of processes (``parallel.distributed``): each host aligns and
overlaps its shard of the preads, records are routed to their contig's
owner host, each host phases the contigs it owns, and host 0 builds the
graph and writes the canonical artifacts (the others write scratch
under ``.host<k>/``).  With ``cfg.profile_dir`` set the whole run is
traced (``utils.profiling``); while a profiler records, the run's host
spans (``utils.profiling.span``: the root ``run_unzip``, which carries
the process's ``rank`` and the ``world`` size, a ``stage.*`` span a
Stage, ``align.*``, ``overlap.*`` on the prefetch's own thread,
``hasm.*``, and ``dist.*`` around each collective of a world of
processes) end ``metrics.jsonl``, one row a span.

Outputs (under <out>/3-unzip/):
  all_p_ctg.fa, all_h_ctg.fa         — primary contigs + haplotigs
  all_h_ctg_ids                      — haplotig id list
  all_phased_reads                   — per-read (ctg, block, phase)
  h_ctg_placements.json              — haplotig placements on primaries
  read_to_contig_map.msgpack         — read tracking (rr_hctg_track role)
"""
from __future__ import annotations

import logging
import os

import numpy as np

from .. import device as _device
from ..config import PipelineConfig
from ..coords import write_m4
from ..io.fasta import read_fasta, write_fasta
from ..io.serialize import deserialize, serialize
from ..models.aligner import AlignerConfig, AlnSet, ReadToContigAligner
from ..models.overlapper import (OverlapperConfig, OverlapSet,
                                 PreadOverlapper)
from ..models.phaser import (phase_contig_device, phase_contigs_batched,
                             phased_reads_table)
from ..models.unzipper import (OvlpFilterConfig, UnzipConfig, Unzipper,
                               phase_filter_mask, place_haplotigs)
from ..oracle.phasing import PhasingConfig
from ..parallel import distributed as dist
from ..parallel.checkpoint import Stage
from ..seq import SeqBatch, decode
from ..utils.metrics import MetricsLog, assembly_stats, phase_block_stats
from ..utils.profiling import log_spans, span

logger = logging.getLogger(__name__)


def run_unzip(cfg: PipelineConfig, device) -> dict:
    """Run 3-unzip on ``device`` (e.g. "cuda" or "cpu"; in a world of
    processes "cuda" is each process's own card)."""
    if cfg.mesh.multihost:
        dist.initialize()
    dev = _device.resolve(device)
    if cfg.profile_dir:  # torch.profiler trace around the whole run
        from ..utils.profiling import device_trace
        with device_trace(cfg.profile_dir, dev, name="unzip"):
            return _run_unzip(cfg, dev)
    return _run_unzip(cfg, dev)


def _run_unzip(cfg: PipelineConfig, dev) -> dict:
    with span("run_unzip", rank=dist.process_index(),
              world=dist.process_count()):
        stats, metrics = _unzip(cfg, dev)
    log_spans(metrics)
    return stats


def _unzip(cfg: PipelineConfig, dev) -> tuple:
    """The run; returns (its stats, its MetricsLog)."""
    cfg.validate()
    # ---- multi-host: host compute is replicated, the EXPENSIVE work
    # (alignment, overlap candidates) is host-sharded, and only host 0
    # writes the canonical artifacts
    if cfg.mesh.debug_sharding:
        from ..parallel import debug
        debug.enable(True)
    multi = dist.process_count() > 1
    out_root = cfg.out_dir
    if multi and not dist.is_primary_host():
        out_root = os.path.join(cfg.out_dir,
                                f".host{dist.process_index()}")
    sync = dist.sync_stage_done if multi else None
    out = os.path.join(out_root, "3-unzip")
    os.makedirs(out, exist_ok=True)
    metrics = MetricsLog(os.path.join(out_root, "metrics.jsonl"))

    preads = read_fasta(cfg.preads)
    logger.info("loaded %d preads", len(preads))

    # ---- stage 0: draft contigs (given, or de novo from the pread graph)
    draft_stage = Stage(out, "0-draft", inputs=[cfg.preads, cfg.draft],
                        outputs=["draft_p_ctg.fa"], resume=cfg.resume,
                        sync=sync)

    overlaps_holder: dict = {}

    def _compute_overlaps(primary_only: bool = False):
        """Host-sharded overlap compute.

        primary_only (the hasm path): the merged OverlapSet is retained
        on host 0 only — the string graph is host-0 work — so other
        hosts return None.  Collective: every host must call."""
        if "ovl" not in overlaps_holder:
            with span("overlap.compute"):
                ov_cfg = OverlapperConfig(
                    k=cfg.overlap.k, band=cfg.overlap.band,
                    min_overlap=cfg.overlap.min_overlap,
                    min_identity=cfg.overlap.min_identity,
                    end_fuzz=cfg.overlap.end_fuzz)
                overlapper = PreadOverlapper(preads, ov_cfg, device=dev)
                if multi:
                    # each host seeds/verifies the candidates of its a-read
                    # shard; the gathered union re-sorts to the identical
                    # overlap stream (OverlapSet.sort_canonical)
                    local = overlapper.compute(dist.host_shard(len(preads)))
                    if primary_only:
                        got = dist.gather_to_primary(local.to_bytes())
                        overlaps_holder["ovl"] = OverlapSet.merge(
                            [OverlapSet.from_bytes(b) for b in got]) \
                            if got is not None else None
                    else:
                        overlaps_holder["ovl"] = OverlapSet.merge(
                            [OverlapSet.from_bytes(b)
                             for b in dist.allgather_bytes(local.to_bytes())])
                else:
                    overlaps_holder["ovl"] = overlapper.compute()
                overlaps_holder["timings"] = overlapper.timings
        return overlaps_holder["ovl"]

    def _draft(st: Stage):
        if cfg.draft:
            batch = read_fasta(cfg.draft)
            recs = [(batch.names[i], batch.to_str(i))
                    for i in range(len(batch))]
        else:
            # de novo: unphased string-graph walk over pread overlaps
            ovl = _compute_overlaps()
            uz = Unzipper(preads,
                          read_block=np.full(len(preads), -1, np.int64),
                          read_phase=np.full(len(preads), -1, np.int8),
                          cfg=UnzipConfig(fuzz=cfg.graph.fuzz,
                                          reduction_fuzz=cfg.graph.reduction_fuzz))
            keep = np.ones(len(ovl), bool)
            res = uz.unzip(ovl, keep)
            recs = [(nm, decode(sq)) for nm, sq, _ in res.p_ctg]
        write_fasta(st.out("draft_p_ctg.fa"), recs)
        return {"n_draft": len(recs)}

    with span("stage.0-draft"):
        draft_stage.run(_draft)
    draft = read_fasta(draft_stage.out("draft_p_ctg.fa"))
    contigs = [draft.row(i) for i in range(len(draft))]

    # ---- contig-owner partition: each host OWNS a length-balanced
    # subset of contigs; post-alignment host work (phasing) runs only on
    # the owner
    n_hosts = dist.process_count()
    owners = dist.contig_owners([len(c) for c in contigs], n_hosts)
    my_host = dist.process_index()

    # ---- stage 1: track + align reads to draft (blasr/phasing prep role)
    # the alignment is computed lazily: a fully up-to-date resume reloads
    # everything downstream from stage outputs and never aligns
    _aln_cache: dict = {}

    def get_aln():
        """Owned-contig AlnSet: host-sharded alignment, records routed to
        each contig's owner host (multi); the full set on one host,
        persisted next to the 1-align stage (written by _track, reloaded
        here when the stage is up to date) so a partial resume does not
        re-align."""
        if "a" not in _aln_cache:
            if not multi:
                blob = os.path.join(out, "1-align", "aln_set.msgpack")
                probe = Stage(
                    out, "1-align",
                    inputs=[cfg.preads, draft_stage.out("draft_p_ctg.fa")],
                    outputs=["read_to_contig_map.msgpack"],
                    resume=cfg.resume)
                if cfg.resume and probe.is_done() \
                        and os.path.exists(blob):
                    with span("align.reload") as sp, \
                            open(blob, "rb") as fh:
                        _aln_cache["a"] = AlnSet.from_bytes(fh.read())
                    metrics.log("align_reload", s=round(sp.s, 2))
                    return _aln_cache["a"]
            with span("align.compute") as sp:
                aligner = ReadToContigAligner(contigs, AlignerConfig(
                    k=cfg.align.k, band=cfg.align.band,
                    window_pad=cfg.align.window_pad,
                    min_identity=cfg.align.min_identity,
                    batch_pairs=cfg.align.batch_pairs), device=dev)
                if multi:
                    # host-sharded alignment: each host seeds + DP-verifies
                    # its read shard, then routes each record to its
                    # contig's OWNER; the owner's canonical merge equals
                    # the one-host records of those contigs
                    local = aligner.align_batch(
                        preads, read_range=dist.host_shard(len(preads)))
                    rec_owner = owners[local.ctg]
                    blobs = [local.subset(rec_owner == d).to_bytes()
                             for d in range(n_hosts)]
                    _aln_cache["a"] = AlnSet.merge(
                        [AlnSet.from_bytes(b)
                         for b in dist.exchange_to_owners(blobs)])
                else:
                    _aln_cache["a"] = aligner.align_batch(preads)
            metrics.log("align_compute", s=round(sp.s, 2),
                        **aligner.timings)
        return _aln_cache["a"]

    def _gather_track_cols():
        """Global per-read placement columns from owner-sharded AlnSets
        (small arrays: O(reads), no tags)."""
        aln = get_aln()
        cols = {"rid": aln.read_id, "ctg": aln.ctg, "ts": aln.t_start,
                "te": aln.t_end, "st": aln.strand.astype(np.int32)}
        if not multi:
            return cols
        parts = [dist.unpack_arrays(b)
                 for b in dist.allgather_bytes(dist.pack_arrays(cols))]
        merged = {k: np.concatenate([p[k] for p in parts])
                  for k in cols}
        order = np.argsort(merged["rid"], kind="stable")
        return {k: v[order] for k, v in merged.items()}

    # ---- overlap prefetch: the hasm overlap compute depends only on the
    # preads, so in single-host mode it runs concurrently with stages 1-2
    # in a dataflow thread (its kernels go to the same device, on that
    # thread's current stream).  Multi-host keeps it synchronous: the
    # compute issues collectives, and two collective streams must not
    # interleave differently across hosts.
    phased_path = os.path.join(out, "all_phased_reads")
    # the probe must declare the SAME outputs as the real 3-hasm stage,
    # or it can report done while the real stage will rerun
    hasm_outputs = ["../all_p_ctg.fa", "../all_h_ctg.fa",
                    "../all_h_ctg_ids", "../h_ctg_placements.json",
                    "../h_ctg_placements.m4", "../preads.ovl"]
    hasm_probe = Stage(out, "3-hasm", inputs=[cfg.preads, phased_path],
                       outputs=hasm_outputs, resume=cfg.resume)
    phasing_probe = Stage(
        out, "2-phasing",
        inputs=[cfg.preads, draft_stage.out("draft_p_ctg.fa")],
        outputs=["../all_phased_reads"], resume=cfg.resume)
    ovl_prefetch = None
    if (not multi and cfg.overlap.prefetch
            and not (hasm_probe.is_done() and phasing_probe.is_done())):
        from ..parallel.dataflow import Prefetch
        ovl_prefetch = Prefetch("overlap-compute", _compute_overlaps)

    align_stage = Stage(out, "1-align",
                        inputs=[cfg.preads, draft_stage.out("draft_p_ctg.fa")],
                        outputs=["read_to_contig_map.msgpack"],
                        resume=cfg.resume, sync=sync)

    def _track(st: Stage):
        cols = _gather_track_cols()
        r2c = {int(cols["rid"][a]): [int(cols["ctg"][a]),
                                     int(cols["ts"][a]),
                                     int(cols["te"][a]),
                                     int(cols["st"][a])]
               for a in range(len(cols["rid"]))}
        serialize(st.out("read_to_contig_map.msgpack"), r2c)
        if not multi:
            # durable AlnSet: partial resumes reload instead of
            # re-aligning (see get_aln); written atomically so a kill
            # mid-write cannot leave a truncated blob that loads
            tmp = st.out("aln_set.msgpack.tmp")
            with open(tmp, "wb") as fh:
                fh.write(get_aln().to_bytes())
            os.replace(tmp, st.out("aln_set.msgpack"))
        metrics.log("align", n_aligned=len(r2c), n_reads=len(preads))
        return {"n_aligned": len(r2c)}

    with span("stage.1-align"):
        align_stage.run(_track)

    # ---- stage 2: per-contig phasing (fc_phasing role), resumable
    n_reads = len(preads)
    read_ctg = np.full(n_reads, -1, np.int64)
    read_block = np.full(n_reads, -1, np.int64)
    read_phase = np.full(n_reads, -1, np.int8)
    phasing_stage = Stage(
        out, "2-phasing",
        inputs=[cfg.preads, draft_stage.out("draft_p_ctg.fa")],
        outputs=["../all_phased_reads"], resume=cfg.resume, sync=sync)

    def _phase(st: Stage):
        ph_cfg = PhasingConfig(
            min_depth=cfg.phase.min_depth,
            min_allele_count=cfg.phase.min_allele_count,
            allele_freq_min=cfg.phase.allele_freq_min,
            biallelic_frac=cfg.phase.biallelic_frac,
            max_span=cfg.phase.max_span, min_link=cfg.phase.min_link)
        from ..parallel.sharding import ShardedPhaseOps, make_pipeline_mesh
        # contig-owner dataflow: per-contig device work never crosses
        # hosts, so the mesh is local in multi-host mode
        mesh = make_pipeline_mesh(cfg.mesh.n_devices, cfg.mesh.window_par,
                                  device=dev, local_only=multi)
        if mesh is not None:
            logger.info("phasing over mesh %s", mesh)
        aln = get_aln()
        my_ctgs = (np.nonzero(owners == my_host)[0] if multi
                   else np.arange(len(contigs)))
        with span("phasing.compute") as sp:
            if mesh is None:
                # grouped batched device ops: a few rounds for ALL contigs
                phs = phase_contigs_batched(
                    aln, [int(c) for c in my_ctgs],
                    [len(contigs[int(c)]) for c in my_ctgs], ph_cfg,
                    device=dev)
            else:
                phase_ops = ShardedPhaseOps(mesh)
                phs = [phase_contig_device(aln, int(ci),
                                           len(contigs[int(ci)]), ph_cfg,
                                           device=dev, phase_ops=phase_ops)
                       for ci in my_ctgs]
        metrics.log("phasing_total", s=round(sp.s, 2), n_ctgs=len(my_ctgs))
        phase_rows = []
        for ci, ph in zip(my_ctgs, phs):
            phase_rows.append(phased_reads_table(ph))
            metrics.log("phasing", ctg=int(ci), n_het=len(ph.het_pos),
                        **phase_block_stats(ph.block_id, ph.het_pos))
        phased = np.concatenate(phase_rows) if phase_rows else \
            np.zeros((0, 4), np.int64)
        if multi:
            # gather the (small) per-contig tables from every owner and
            # restore ascending-contig order (stable, so within-contig
            # row order is each owner's deterministic table order)
            parts = [dist.unpack_arrays(b)["t"] for b in
                     dist.allgather_bytes(dist.pack_arrays({"t": phased}))]
            phased = np.concatenate(parts)
            phased = phased[np.argsort(phased[:, 1], kind="stable")]
        # first-contig-wins read assignment (a read maps to one contig;
        # keep the first)
        for rid, ctg, blk, phs in phased:
            rid = int(rid)
            if read_ctg[rid] < 0:
                read_ctg[rid] = int(ctg)
                read_block[rid] = int(blk)
                read_phase[rid] = int(phs)
        with open(phased_path, "w") as fh:
            for rid, ctg, blk, phs in phased:
                if blk >= 0:
                    fh.write(f"{int(ctg):06d}F {int(blk)} {int(phs)} "
                             f"{_read_name(preads, int(rid))}\n")
        return {"n_phased": int((read_block >= 0).sum())}

    with span("stage.2-phasing"):
        phased_now = phasing_stage.run(_phase)
    if not phased_now:
        # resume: rebuild the per-read phase arrays from the stage output
        name_to_id = {_read_name(preads, r): r for r in range(n_reads)}
        with open(phased_path) as fh:
            for line in fh:
                ctg_s, blk, phs, name = line.split()
                rid = name_to_id.get(name)
                if rid is not None:
                    read_ctg[rid] = int(ctg_s.rstrip("F"), 10)
                    read_block[rid] = int(blk)
                    read_phase[rid] = int(phs)

    # ---- stage 3: hasm — phase-filtered overlaps + graph + haplotigs
    hasm_stage = Stage(
        out, "3-hasm", inputs=[cfg.preads, phased_path],
        outputs=hasm_outputs, resume=cfg.resume, sync=sync)

    def _hasm(st: Stage):
        # graph construction + haplotig extraction is HOST-0 work (the
        # string graph is global); other hosts take part in the
        # collective overlap compute, keep nothing, and wait at the
        # final barrier
        with span("hasm.overlaps") as sp:
            if ovl_prefetch is not None:
                with span("hasm.join_wait"):
                    ovl_prefetch.get()  # join the dataflow handle; re-raises
            ovl = _compute_overlaps(primary_only=True)
        metrics.log("hasm_overlaps", s=round(sp.s, 2),
                    **overlaps_holder.get("timings", {}))
        if multi and not dist.is_primary_host():
            return {}
        keep = phase_filter_mask(ovl, read_ctg, read_block, read_phase,
                                 OvlpFilterConfig(
                                     min_overlap=cfg.overlap.min_overlap,
                                     min_identity=cfg.overlap.min_identity,
                                     fuzz=cfg.overlap.end_fuzz,
                                     max_diff=cfg.overlap.max_diff,
                                     max_cov=cfg.overlap.max_cov,
                                     min_cov=cfg.overlap.min_cov,
                                     bestn=cfg.overlap.bestn))
        metrics.log("ovlp_filter", n_overlaps=len(ovl),
                    n_kept=int(keep.sum()))

        # read placements come from the stage-1 track output, so a warm
        # hasm re-run does not need the aligner
        r2c = deserialize(align_stage.out("read_to_contig_map.msgpack"))
        t_start = np.full(n_reads, -1, np.int64)
        t_end = np.full(n_reads, -1, np.int64)
        p_ctg_of = np.full(n_reads, -1, np.int64)
        p_strand = np.zeros(n_reads, np.int8)
        for rid, rec in r2c.items():
            p_ctg_of[int(rid)] = int(rec[0])
            t_start[int(rid)] = int(rec[1])
            t_end[int(rid)] = int(rec[2])
            p_strand[int(rid)] = int(rec[3]) if len(rec) > 3 else 0

        uz = Unzipper(preads, read_block, read_phase, read_ctg=read_ctg,
                      placements=(t_start, t_end),
                      placement_ctg=p_ctg_of,
                      placement_strand=p_strand,
                      draft_seqs=contigs,
                      cfg=UnzipConfig(
                          fuzz=cfg.graph.fuzz,
                          reduction_fuzz=cfg.graph.reduction_fuzz,
                          max_bubble_steps=cfg.graph.max_bubble_steps))
        with span("hasm.graph_walk") as sp:
            res = uz.unzip(ovl, keep)
        metrics.log("hasm_graph_walk", s=round(sp.s, 2),
                    n_rescues=uz.n_rescues, n_fills=uz.n_fills)

        # ---- optional haplotig dedup (fc_dedup_h_tigs role); the
        # verbatim dedup and placement code builds its aligners without
        # a device argument, so they run inside the device scope
        with span("hasm.dedup") as sp:
            if cfg.graph.dedup and res.h_ctg:
                from ..models.dedup import dedup_haplotigs
                p_b = SeqBatch.from_strs([sq for _, sq, _ in res.p_ctg])
                h_b = SeqBatch.from_strs([h.seq for h in res.h_ctg])
                with _device.scope(dev):
                    kept = set(dedup_haplotigs(
                        p_b, h_b,
                        max_identity=cfg.graph.dedup_max_identity))
                dropped = len(res.h_ctg) - len(kept)
                res.h_ctg = [h for i, h in enumerate(res.h_ctg)
                             if i in kept]
                metrics.log("dedup", n_dropped=dropped,
                            n_kept=len(res.h_ctg))

        metrics.log("hasm_dedup", s=round(sp.s, 2))

        # ---- haplotig placement by re-alignment (SURVEY.md §3.3 step 3)
        with span("hasm.placement") as sp:
            with _device.scope(dev):
                m4 = place_haplotigs(res.p_ctg, res.h_ctg,
                                     band=max(512, cfg.align.band))
            write_m4(os.path.join(out, "h_ctg_placements.m4"), m4)
        metrics.log("hasm_placement", s=round(sp.s, 2))

        # ---- graph + overlap intermediates
        # (sg_edges_list / utg_data / ctg_paths / sg.gfa / LA dump)
        if res.graph is not None:
            res.graph.write_sg_edges(os.path.join(out, "sg_edges_list"),
                                     names=preads.names)
            res.graph.write_utg_data(os.path.join(out, "utg_data"),
                                     names=preads.names)
            from ..io.gfa import write_ctg_paths, write_sg_gfa
            write_ctg_paths(os.path.join(out, "ctg_paths"), res.p_ctg,
                            res.p_paths, res.graph, names=preads.names)
            write_sg_gfa(os.path.join(out, "sg.gfa"), res.graph,
                         preads.lengths, names=preads.names)
        from ..io.overlaps import write_overlaps
        write_overlaps(os.path.join(out, "preads.ovl"), ovl,
                       names=preads.names)

        # ---- gather outputs
        write_fasta(os.path.join(out, "all_p_ctg.fa"),
                    ((nm, decode(sq)) for nm, sq, _ in res.p_ctg))
        write_fasta(os.path.join(out, "all_h_ctg.fa"),
                    ((h.name, decode(h.seq)) for h in res.h_ctg))
        with open(os.path.join(out, "all_h_ctg_ids"), "w") as fh:
            for h in res.h_ctg:
                fh.write(h.name + "\n")
        serialize(os.path.join(out, "h_ctg_placements.json"),
                  [{"h": h.name, "p": h.primary, "start": h.p_start,
                    "end": h.p_end, "phase": int(h.phase),
                    "n_reads": len(h.reads)} for h in res.h_ctg])

        p_stats = assembly_stats([sq for _, sq, _ in res.p_ctg])
        h_stats = assembly_stats([h.seq for h in res.h_ctg])
        metrics.log("unzip", p=p_stats, h=h_stats)
        return {"p_ctg": p_stats, "h_ctg": h_stats}

    with span("stage.3-hasm"):
        hasm_stage.run(_hasm)
    stats = hasm_stage.metrics()
    logger.info("unzip done: %s primary, %s haplotigs",
                stats.get("p_ctg"), stats.get("h_ctg"))
    if multi:   # canonical artifacts complete before any host reads them
        dist.barrier("unzip-done")
    return {**stats, "out_dir": out}, metrics


def _read_name(batch, rid: int) -> str:
    if batch.names:
        return batch.names[rid]
    return f"read/{rid}"
