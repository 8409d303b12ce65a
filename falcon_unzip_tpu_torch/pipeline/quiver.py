"""4-polish pipeline driver (the fc_quiver.py role) on one torch device.

Port of ``falcon_unzip_tpu.pipeline.quiver`` for a single process on one
device.  Same stages, Stage markers, resume and persisted AlnSet as the
reference: raw reads are aligned to the combined p_ctg + h_ctg reference
(1-track), routed by phase against each primary, and every contig is
polished with the windowed vote + Arrow splice stage (2-polish), the
splice sweeps on ``device``.  With one device the reference builds no
mesh, so the splicer is the plain ``ArrowSplicer`` and the votes are
built on the host; that path is the one mirrored here.  Not ported yet
(each raises NotImplementedError): multi-host runs
(``cfg.mesh.multihost``), profiler traces (``cfg.profile_dir``) and a
mesh of more than one device (``cfg.mesh.n_devices > 1``).

Outputs (under <out>/4-polish/):
  cns_p_ctg.fasta / cns_p_ctg.fastq
  cns_h_ctg.fasta / cns_h_ctg.fastq
  read_to_contig_map.msgpack
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np

from .. import device as _device
from ..config import PipelineConfig
from ..io.fasta import read_fasta, write_fasta, write_fastq
from ..io.ingest import read_seqs
from ..io.serialize import serialize
from ..models.aligner import AlignerConfig, AlnSet, ReadToContigAligner
from ..models.phaser import template_route_votes
from ..models.polisher import Polisher, PolisherConfig, phred_to_tiers
from ..ops.pairhmm import params_vector
from ..oracle.hmm import params_for_read_qv
from ..oracle.phasing import PhasingConfig
from ..parallel.checkpoint import Stage
from ..seq import decode
from ..utils.metrics import MetricsLog, assembly_stats

logger = logging.getLogger(__name__)


def run_quiver(cfg: PipelineConfig, device) -> dict:
    """Run 4-polish on ``device`` (e.g. "cuda" or "cpu") over the
    3-unzip outputs in ``cfg.out_dir``."""
    if cfg.mesh.multihost:
        raise NotImplementedError("multi-host runs are not ported yet")
    if cfg.profile_dir:
        raise NotImplementedError("profiler traces are not ported yet")
    if cfg.mesh.n_devices > 1:
        raise NotImplementedError("a mesh of more than one device is not "
                                  "ported yet")
    dev = _device.resolve(device)
    unzip_dir = os.path.join(cfg.out_dir, "3-unzip")
    out = os.path.join(cfg.out_dir, "4-polish")
    os.makedirs(out, exist_ok=True)
    metrics = MetricsLog(os.path.join(cfg.out_dir, "metrics.jsonl"))

    p_path = os.path.join(unzip_dir, "all_p_ctg.fa")
    h_path = os.path.join(unzip_dir, "all_h_ctg.fa")
    if not os.path.exists(p_path):
        raise FileNotFoundError(f"run the unzip stage first: {p_path}")
    p_batch = read_fasta(p_path)
    h_batch = read_fasta(h_path) if os.path.exists(h_path) else None

    names = list(p_batch.names or [])
    contigs = [p_batch.row(i) for i in range(len(p_batch))]
    n_primary = len(contigs)
    if h_batch is not None and len(h_batch):
        names += list(h_batch.names or [])
        contigs += [h_batch.row(i) for i in range(len(h_batch))]

    reads_path = cfg.reads or cfg.preads
    reads = read_seqs(reads_path)   # FASTA/FASTQ/BAM or .fofn of them
    logger.info("polish: %d reads vs %d contigs", len(reads), len(contigs))

    # reads are aligned once, lazily: if every stage below is up to date
    # on resume, the alignment never runs
    _aln: dict = {}

    def get_aln():
        """The AlnSet, persisted next to 1-track (written by _track,
        reloaded here while the stage is up to date) so a kill
        mid-polish resumes without re-paying the raw-read alignment."""
        if "a" not in _aln:
            blob = os.path.join(out, "1-track", "aln_set.msgpack")
            probe = Stage(out, "1-track",
                          inputs=[reads_path, p_path, h_path],
                          outputs=["read_to_contig_map.msgpack"],
                          resume=cfg.resume)
            if cfg.resume and probe.is_done() and os.path.exists(blob):
                _t0 = time.perf_counter()
                with open(blob, "rb") as fh:
                    _aln["a"] = AlnSet.from_bytes(fh.read())
                metrics.log("align_reload",
                            s=round(time.perf_counter() - _t0, 2))
                return _aln["a"]
            _t0 = time.perf_counter()
            aligner = ReadToContigAligner(contigs, AlignerConfig(
                k=cfg.align.k, band=cfg.align.band,
                window_pad=cfg.align.window_pad,
                min_identity=cfg.align.min_identity,
                batch_pairs=cfg.align.batch_pairs), device=dev)
            _aln["a"] = aligner.align_batch(reads)
            metrics.log("align_compute",
                        s=round(time.perf_counter() - _t0, 2),
                        **aligner.timings)
        return _aln["a"]

    # ---- stage 1: track reads -> combined reference (rr_hctg_track role)
    track_stage = Stage(out, "1-track", inputs=[reads_path, p_path, h_path],
                        outputs=["read_to_contig_map.msgpack"],
                        resume=cfg.resume)

    def _track(st: Stage):
        aln = get_aln()
        r2c = {int(aln.read_id[a]): int(aln.ctg[a]) for a in range(len(aln))}
        serialize(st.out("read_to_contig_map.msgpack"), r2c)
        tmp = st.out("aln_set.msgpack.tmp")
        with open(tmp, "wb") as fh:
            fh.write(aln.to_bytes())
        os.replace(tmp, st.out("aln_set.msgpack"))
        return {"n_aligned": len(r2c)}

    track_stage.run(_track)

    # ---- stage 2: windowed polish (variantCaller/arrow role), resumable
    polish_stage = Stage(
        out, "2-polish", inputs=[reads_path, p_path, h_path],
        outputs=["../cns_p_ctg.fasta", "../cns_p_ctg.fastq",
                 "../cns_h_ctg.fasta", "../cns_h_ctg.fastq"],
        resume=cfg.resume)

    def _polish(st: Stage):
        pcfg = PolisherConfig(
            window=cfg.polish.window, overlap=cfg.polish.overlap,
            min_cov=cfg.polish.min_cov,
            del_min_cov=cfg.polish.del_min_cov,
            arrow_rounds=cfg.polish.arrow_rounds,
            arrow_candidates=cfg.polish.arrow_candidates,
            arrow_min_cov=cfg.polish.arrow_min_cov,
            margin_frac=cfg.polish.margin_frac,
            het_skip_frac=cfg.polish.het_skip_frac,
            hmm_band=cfg.polish.hmm_band,
            score_batch=cfg.polish.score_batch,
            splice_chunk=cfg.polish.splice_chunk,
            use_pallas=None if cfg.polish.use_pallas else False)
        read_pvecs = None
        read_qtiers = None
        if cfg.polish.qv_aware and getattr(reads, "base_qv", None) \
                is not None and any(len(t) for t in reads.base_qv):
            # PER-BASE tier conditioning (real Arrow's IQV/DQV role):
            # each read's phred track maps to tier ids; reads without a
            # track get tier 0 = global params
            read_qtiers = [
                phred_to_tiers(t) if len(t) else np.zeros(0, np.int8)
                for t in reads.base_qv]
            logger.info(
                "qv-aware polish: PER-BASE tiers for %d reads",
                sum(1 for t in read_qtiers if len(t)))
        elif cfg.polish.qv_aware and reads.mean_qv is not None:
            # base-quality tier: per-read params from the mean phred
            # track (reads without one, qv<=0, keep global params)
            read_pvecs = np.stack(
                [params_vector(params_for_read_qv(float(q)))
                 for q in reads.mean_qv])
            logger.info("qv-aware polish: %d reads with quality tiers",
                        int((reads.mean_qv > 0).sum()))
        polisher = Polisher(pcfg, read_pvecs=read_pvecs,
                            read_qtiers=read_qtiers, device=dev)
        my = np.arange(len(contigs))
        aln = get_aln()
        seg_excl = None
        if cfg.polish.phase_aware:
            # phase-aware read routing (the [U] rr_hctg_track role done
            # at the pileup level): records that oppose the primary's own
            # alleles at the het sites they span are masked, so each
            # phase block polishes to one consistent haplotype
            _t0 = time.perf_counter()
            ph_cfg = PhasingConfig(
                min_depth=cfg.phase.min_depth,
                min_allele_count=cfg.phase.min_allele_count,
                allele_freq_min=cfg.phase.allele_freq_min,
                biallelic_frac=cfg.phase.biallelic_frac,
                max_span=cfg.phase.max_span, min_link=cfg.phase.min_link)
            prim = [int(i) for i in my if int(i) < n_primary]
            routed = template_route_votes(
                aln, prim, [len(contigs[i]) for i in prim],
                [contigs[i] for i in prim], ph_cfg, device=dev)
            # opposite-phase records are MASKED, not dropped: their votes
            # at het columns (and +-1 neighbors) are stripped and they sit
            # out Arrow segment scoring, but they still vote everywhere
            # else.  Masking works on a shallow copy: the cached AlnSet
            # is shared, and replaced entries are fresh arrays.
            aln = dataclasses.replace(aln, tags=list(aln.tags))
            seg_excl = np.zeros(len(aln), bool)
            n_drop = 0
            for rec_idx, votes, het in routed:
                bad = rec_idx[votes < 0]
                n_drop += len(bad)
                seg_excl[bad] = True
                if not len(het) or not len(bad):
                    continue
                hs = np.sort(np.asarray(het))
                for a in bad:
                    t = aln.tags[a]
                    if t is None or not len(t):
                        continue
                    j = np.searchsorted(hs, t[:, 0])
                    near = (np.abs(hs[np.clip(j, 0, len(hs) - 1)]
                                   - t[:, 0]) <= 1)
                    near |= (np.abs(hs[np.clip(j - 1, 0, len(hs) - 1)]
                                    - t[:, 0]) <= 1)
                    aln.tags[a] = t[~near]
            metrics.log("polish_phase_route", n_dropped=n_drop,
                        s=round(time.perf_counter() - _t0, 2))
        _t0 = time.perf_counter()
        polished = polisher.polish_all(
            [(names[int(i)], contigs[int(i)]) for i in my], aln,
            ids=[int(i) for i in my], seg_exclude=seg_excl)
        metrics.log("polish_windows",
                    s=round(time.perf_counter() - _t0, 2))
        p_out = [c for i, c in enumerate(polished) if i < n_primary]
        h_out = [c for i, c in enumerate(polished) if i >= n_primary]
        _emit(out, "cns_p_ctg", p_out)
        _emit(out, "cns_h_ctg", h_out)
        return {
            "p": assembly_stats([c.seq for c in p_out]),
            "h": assembly_stats([c.seq for c in h_out]),
            "mean_qv": round(float(np.mean([c.qv.mean() for c in polished
                                            if len(c.qv)])), 2)
            if polished else 0.0,
        }

    polish_stage.run(_polish)
    stats = polish_stage.metrics()
    metrics.log("polish", **stats)
    logger.info("polish done: %s", stats)
    return {**stats, "out_dir": out}


def _phase_route_mask(aln, ctg_ids: list[int], t_lens: list[int],
                      templates: list, cfg: PipelineConfig,
                      phase_ops=None) -> "np.ndarray":
    """Per-record keep mask dropping reads whose alleles OPPOSE the
    template's own haplotype at the het sites they span.

    Role parity: [U] fc_rr_hctg_track + fc_get_read_hctg_map partition
    raw reads by phase before quiver maps them ([U] SURVEY.md §3.4 step
    1).  The partition needs no association table or phase blocks: the
    polish template IS one haplotype per phase block, so a record is
    kept iff it agrees with the template's own allele at a majority of
    the het sites it covers (+1 template allele / -1 opposite allele
    per site, drop on a net-negative vote).  Batched het calling + one
    vote scatter across ALL contigs replaces the full per-contig
    re-phasing that was the 4th-largest wall-clock item at 10 Mb
    (VERDICT r3 weak #7).  Records spanning no usable het site keep.

    phase_ops is accepted for API compatibility and unused — the vote
    path has no collective component."""
    from ..models.phaser import template_route_votes
    from ..oracle.phasing import PhasingConfig
    keep = np.ones(len(aln), bool)
    ph_cfg = PhasingConfig(
        min_depth=cfg.phase.min_depth,
        min_allele_count=cfg.phase.min_allele_count,
        allele_freq_min=cfg.phase.allele_freq_min,
        biallelic_frac=cfg.phase.biallelic_frac,
        max_span=cfg.phase.max_span, min_link=cfg.phase.min_link)
    for rec_idx, votes, _het in template_route_votes(
            aln, ctg_ids, t_lens, templates, ph_cfg):
        keep[rec_idx[votes < 0]] = False
    return keep


def _emit(out_dir: str, stem: str, contigs) -> None:
    write_fasta(os.path.join(out_dir, f"{stem}.fasta"),
                ((c.name, decode(c.seq)) for c in contigs))
    write_fastq(os.path.join(out_dir, f"{stem}.fastq"),
                ((c.name, decode(c.seq),
                  "".join(chr(33 + int(q)) for q in c.qv))
                 for c in contigs))
