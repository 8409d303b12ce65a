"""Typed configuration tree for the unzip + polish pipelines.

Role parity: [U] fc_unzip.cfg — an INI file with [General]/[Unzip]
sections parsed ad hoc by the flow builder (SURVEY.md §1 L6, §5 config).
Re-design per SURVEY.md §5: one dataclass tree with explicit validation,
INI *and* JSON loading (fc_unzip.cfg files remain readable), and
per-stage kernel tuning knobs (band width, window length, batch sizes,
mesh shape) in place of cluster scheduler keys.

Legacy keys accepted from [Unzip]: ``input_fofn``, ``input_bam_fofn``
(mapped to read inputs); concurrency keys (``unzip_blasr_concurrent_jobs``
etc.) are accepted and ignored with a warning — device batching replaces
process fan-out.
"""
from __future__ import annotations

import configparser
import dataclasses
import json
import logging
import os

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class AlignCfg:
    k: int = 13
    max_hits: int = 64
    band: int = 256
    window_pad: int = 48
    min_identity: float = 0.65
    batch_pairs: int = 256


@dataclasses.dataclass
class PhaseCfg:
    min_depth: int = 10
    min_allele_count: int = 2
    allele_freq_min: float = 0.25
    biallelic_frac: float = 0.8
    max_span: int = 64
    min_link: int = 3


@dataclasses.dataclass
class OverlapCfg:
    k: int = 13
    band: int = 256
    min_overlap: int = 500
    min_identity: float = 0.70
    end_fuzz: int = 60
    # falcon coverage filters (fc_ovlp_filter knobs carried into
    # ovlp_filter_with_phase); 0 disables the corresponding filter
    max_diff: int = 100          # |left - right| end coverage asymmetry
    max_cov: int = 300           # repeat suppression
    min_cov: int = 1             # chimera suppression
    bestn: int = 10              # longest-n overlaps per (read, end)
    prefetch: bool = True        # compute overlaps on the dataflow engine
                                 # concurrently with align+phasing
                                 # (single-host; hasm joins the handle)


@dataclasses.dataclass
class GraphCfg:
    fuzz: int = 60
    reduction_fuzz: int = 100
    max_bubble_steps: int = 64
    dedup: bool = False              # drop h_ctgs duplicating their primary
    dedup_max_identity: float = 0.99  # (fc_dedup_h_tigs role)


@dataclasses.dataclass
class PolishCfg:
    window: int = 384
    overlap: int = 64
    min_cov: int = 3
    del_min_cov: int = 5  # GAP must carry at least this much coverage
                          # to delete a template base: correlated read
                          # deletions (homopolymer contexts) winning
                          # 2-vs-1 votes in low-coverage pockets were
                          # the dominant residual-error mode at 1 Mb
    arrow_rounds: int = 12       # max rounds; windows stop at convergence
    arrow_candidates: int = 4    # low-margin columns tested per round
                                 # (queue chunk size; full queue cycles)
    arrow_min_cov: int = 5       # full-span reads gating mutation testing
    margin_frac: float = 0.7
    het_skip_frac: float = 0.35  # balanced-biallelic column gate
                                 # (models.polisher.PolisherConfig)
    hmm_band: int = 48
    score_batch: int = 8192      # legacy re-forward pairs per dispatch
    splice_chunk: int = 512      # (read, window) pairs per splice dispatch
    use_pallas: bool = True      # TPU path for the HMM scorer (auto)
    qv_aware: bool = False       # per-read base-quality HMM tier: reads
                                 # with a FASTQ/BAM quality track get
                                 # emission/transition params scaled to
                                 # their mean QV (oracle.hmm.
                                 # params_for_read_qv)
    phase_aware: bool = True     # phase raw reads against each primary
                                 # and drop the phase group opposing the
                                 # template's alleles per block (the
                                 # rr_hctg_track phased-partition role;
                                 # fixes mixed-phase het-site polish)


@dataclasses.dataclass
class MeshCfg:
    n_devices: int = 0           # 0 = all available
    window_par: int = 0          # 0 = auto
    # sharding-invariant debug mode (SURVEY.md §5 race detection): every
    # mesh-sharded op re-executes its single-device reference and
    # asserts equality (parallel.debug); also FALCON_UNZIP_TPU_DEBUG_SHARDING=1
    debug_sharding: bool = False
    # multi-host (jax.distributed) execution: when true the drivers call
    # parallel.distributed.initialize() (coordinator/process env vars or
    # TPU pod metadata), host-shard the aligner/overlapper input, run the
    # sharded device steps over the GLOBAL mesh, and emit canonical
    # artifacts from host 0 only (other hosts write .host<k>/ scratch).
    multihost: bool = False


@dataclasses.dataclass
class PipelineConfig:
    # inputs
    preads: str = ""             # FASTA(.gz) of error-corrected reads
    reads: str = ""              # FASTA/FASTQ(.gz) raw reads for polish
    draft: str = ""              # optional draft p_ctg FASTA (else de novo)
    out_dir: str = "./fc_unzip_tpu_out"
    profile_dir: str = ""        # write a jax.profiler trace per driver run
    # stages
    align: AlignCfg = dataclasses.field(default_factory=AlignCfg)
    phase: PhaseCfg = dataclasses.field(default_factory=PhaseCfg)
    overlap: OverlapCfg = dataclasses.field(default_factory=OverlapCfg)
    graph: GraphCfg = dataclasses.field(default_factory=GraphCfg)
    polish: PolishCfg = dataclasses.field(default_factory=PolishCfg)
    mesh: MeshCfg = dataclasses.field(default_factory=MeshCfg)
    resume: bool = True          # skip stages whose outputs exist

    def validate(self) -> None:
        if not self.preads:
            raise ValueError("config: 'preads' input is required")
        if self.align.band % 2:
            raise ValueError("align.band must be even")
        if self.polish.window <= self.polish.overlap:
            raise ValueError("polish.window must exceed polish.overlap")
        if self.phase.allele_freq_min <= 0 or self.phase.allele_freq_min > 0.5:
            raise ValueError("phase.allele_freq_min must be in (0, 0.5]")


_SECTIONS = {
    "align": AlignCfg, "phase": PhaseCfg, "overlap": OverlapCfg,
    "graph": GraphCfg, "polish": PolishCfg, "mesh": MeshCfg,
}

_LEGACY_IGNORED = {
    "job_type", "job_queue", "jobqueue", "smrt_bin", "sge_option",
    "unzip_blasr_concurrent_jobs", "unzip_phasing_concurrent_jobs",
    "quiver_concurrent_jobs", "max_n_open_files",
    "polish_include_zmw_all_subreads",
}


def _coerce(cls, key: str, val: str):
    for f in dataclasses.fields(cls):
        if f.name == key:
            if f.type in ("int", int):
                return int(val)
            if f.type in ("float", float):
                return float(val)
            if f.type in ("bool", bool):
                return str(val).lower() in ("1", "true", "yes", "on")
            return val
    raise KeyError(key)


def load_config(path: str) -> PipelineConfig:
    """Load JSON or INI (fc_unzip.cfg-style) config."""
    cfg = PipelineConfig()
    if path.endswith(".json"):
        with open(path) as fh:
            data = json.load(fh)
        for sec, val in data.items():
            if sec in _SECTIONS:
                sub = getattr(cfg, sec)
                for k, v in val.items():
                    setattr(sub, k, v)
            else:
                setattr(cfg, sec, val)
    else:
        ini = configparser.ConfigParser()
        ini.read(path)
        for sec in ini.sections():
            lsec = sec.lower()
            for k, v in ini.items(sec):
                if k in _LEGACY_IGNORED or any(
                        k.startswith(p) for p in ("sge_option",)):
                    logger.warning(
                        "config: legacy scheduler key '%s' ignored "
                        "(device batching replaces job fan-out)", k)
                    continue
                if lsec in _SECTIONS:
                    try:
                        setattr(getattr(cfg, lsec), k,
                                _coerce(_SECTIONS[lsec], k, v))
                    except KeyError:
                        logger.warning("config: unknown key [%s] %s", sec, k)
                elif k in ("input_fofn", "preads"):
                    cfg.preads = _first_of_fofn(v)
                elif k in ("input_bam_fofn", "reads"):
                    cfg.reads = _first_of_fofn(v)
                elif hasattr(cfg, k):
                    setattr(cfg, k, v)
                else:
                    logger.warning("config: unknown key [%s] %s", sec, k)
    return cfg


def _first_of_fofn(path_or_file: str) -> str:
    """A .fofn lists input files; single-file configs pass through."""
    if path_or_file.endswith(".fofn") and os.path.exists(path_or_file):
        with open(path_or_file) as fh:
            names = [ln.strip() for ln in fh if ln.strip()]
        return names[0] if len(names) == 1 else path_or_file
    return path_or_file
