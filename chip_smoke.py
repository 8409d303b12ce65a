"""GPU smoke run of the PyTorch + CUDA port (falcon_unzip_tpu_torch).

    python3 chip_smoke.py [--genome-bp N]

Needs one NVIDIA GPU, nvcc and the repository beside this script; imports
nothing of JAX.  Phases, one line each or more, any failure exits
non-zero:

1. card: name and power limit (nvidia-smi), torch / CUDA / nvcc versions;
2. build the CUDA kernels from falcon_unzip_tpu_torch/csrc/ (one nvcc per
   source, all at once);
3. kernel parity: each kernel against its plain torch version on the card
   at the main path's shapes.  Banded wavefront and traceback: P=256;
   W 128/256/512; global, qglocal and tglocal; query buckets 1024/2048
   with their target buckets; bit-exact.  Pair-HMM forward: P=256, 512 bp
   windows (Dmax 1025), W 64/128/256.  Arrow splice sweeps: P=512,
   Lq=LJ=640, C=4, per-pair params and per-base tiers (T=6).  Seeded pairs
   at 0% and 15% error; the float kernels within
   |kernel - plain| <= 1e-3 * max(1, |plain|).  Pair-HMM step ablation:
   the five feature sets at the constants of scripts/ablate_pallas.py
   (P=256, W=128, Dmax=1025, LQG=1024), from the script's NEG start equal
   (tolerance 0), and at a seeded probe where each part changes the
   output, equal without the logaddexps and within 1e-5 relative with
   them; each set's time from the NEG and from a seeded start beside the
   card's name and power limit;
4. golden fixture: 3-unzip and 4-polish on cuda through the port's
   command line must reproduce the five golden hashes of
   tests/test_golden.py, and cns_*.fastq must carry the sequences of a
   4-polish run of the plain versions on the CPU, QVs within 1;
4b. re-forward polish: the golden fixture's contigs and raw-read AlnSet
   polished with Polisher(scorer=PairHMMScorer(device="cuda")), every
   covered column a mutation candidate (margin_frac 1.01), equal the
   same run with the scorer's plain version on the card, and the window
   of tests/test_polisher.py::test_arrow_matches_window_oracle equals
   oracle.hmm.polish_window_oracle;
5. the main path at size: 3-unzip then 4-polish on cuda over a diploid
   genome of --genome-bp (default 1 Mb) with the n50 contig profile, 25x
   preads and 29x raw reads at 3% error (the recipe of
   scripts/e2e_bench.py); per-stage seconds, kernel launches, device ms,
   cell rate, peak device memory and the cns statistics;
6. the ablation path: python -m falcon_unzip_tpu_torch.scripts.ablate_pairhmm
   (each set's time beside the card's name and power limit);
7. the kernel bench: python -m falcon_unzip_tpu_torch.cli bench, its JSON
   line printed as it is;
8. the kernels line (each kernel's launches on its path, its time at the
   main path's shape beside its plain version's and its bound) and the
   result line.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def phase_card(torch) -> str:
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false")
    from falcon_unzip_tpu_torch.bench import card_label
    from falcon_unzip_tpu_torch.ops import _kernels
    smi = card_label()
    nvcc = subprocess.run([_kernels._nvcc(), "--version"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1 card] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {nvcc}", flush=True)
    return smi


def phase_build() -> None:
    from falcon_unzip_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    _kernels._load()
    ptxas = [ln.strip() for ln in _kernels.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[2 build] {time.perf_counter() - t0:.2f} s | "
          + " | ".join(ptxas), flush=True)


def _pairs(rng, P, bq, mode):
    """P seeded (query, target) pairs for query bucket bq: half exact,
    half at 15% error; query lengths in (bq/2, bq].  Returns lists of
    int8 base-code arrays."""
    from falcon_unzip_tpu_torch.utils.simulate import (mutate_read,
                                                       random_genome)
    qs, ts = [], []
    for k in range(P):
        err = 0.0 if k < P // 2 else 0.15
        L = int(rng.integers(bq // 2 + 1, bq + 1))
        if mode == "global":
            t = random_genome(L, int(rng.integers(1 << 30)))
            q = mutate_read(t, err, rng)[:bq]
        else:
            pad = int(rng.integers(40, 300))
            t = random_genome(L + pad, int(rng.integers(1 << 30)))
            off = int(rng.integers(0, pad))
            q = mutate_read(t[off : off + L], err, rng)[:bq]
        qs.append(q)
        ts.append(t)
    return qs, ts


def _padded(np, seqs, width):
    """PAD-filled (len(seqs), width) int8 batch and its lengths."""
    out = np.full((len(seqs), width), 4, np.int8)     # 4: PAD / N
    for k, s in enumerate(seqs):
        out[k, : len(s)] = s
    return out, np.array([len(s) for s in seqs], np.int32)


def _time_ms(torch, fn, reps):
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_parity_align(torch, np) -> dict:
    from falcon_unzip_tpu_torch import bench
    from falcon_unzip_tpu_torch.models.aligner import _t_bucket
    from falcon_unzip_tpu_torch.ops import banded_align as ba
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    P = 256
    shapes = {}
    for W in (128, 256, 512):
        for mode in ("global", "qglocal", "tglocal"):
            for bq in (1024, 2048, 4096):
                qs, ts = _pairs(rng, P, bq, mode)
                bt = _t_bucket(max(len(x) for x in ts), bq)
                q, n = _padded(np, qs, bq)
                t, m = _padded(np, ts, bt)
                # the schedule exactly as BandedAligner.dispatch cuts it
                Dmax, lo = ba.build_schedule(bq, bt, W)
                need = int((n + m).max()) + 1
                Dmax = min(Dmax, -(-need // 1024) * 1024)
                lo = lo[:Dmax]
                qg, trg, G = ba.prepare_batch(q, t, W)
                args = (torch.from_numpy(qg).to(dev),
                        torch.from_numpy(trg).to(dev),
                        torch.from_numpy(n).to(dev),
                        torch.from_numpy(m).to(dev), lo)
                kw = dict(W=W, Lt=bt, G=G, mode=mode)
                k = ba.banded_align_batch(*args, **kw)
                t0 = time.perf_counter()
                p = ba.banded_align_batch_plain(*args, **kw)
                torch.cuda.synchronize()
                plain_ms = 1e3 * (time.perf_counter() - t0)
                wf_err = max(int((k[key] - p[key]).abs().max())
                             for key in ("dist", "end_i", "end_j"))
                wf_err = max(wf_err, int((ba.unpack_bp(k["bp"], Dmax).int()
                                          - ba.unpack_bp(p["bp"], Dmax).int()
                                          ).abs().max()))
                for key in ("dist", "end_i", "end_j", "bp"):
                    if not torch.equal(k[key], p[key]):
                        _fail(f"wavefront {key} differs at W={W} {mode} "
                              f"bq={bq}")
                steps = Dmax - 1
                tk = ba.traceback_batch(k["bp"], lo, k["end_i"], k["end_j"],
                                        max_steps=steps)
                t0 = time.perf_counter()
                tp = ba.traceback_batch_plain(p["bp"], lo, p["end_i"],
                                              p["end_j"], max_steps=steps)
                torch.cuda.synchronize()
                plain_tb_ms = 1e3 * (time.perf_counter() - t0)
                tb_err = int((tk.int() - tp.int()).abs().max())
                if not torch.equal(tk, tp):
                    _fail(f"traceback differs at W={W} {mode} bq={bq}")
                n_moves = int((tk != ba.MOVE_NONE).sum())
                wf_ms = _time_ms(torch, lambda: ba.banded_align_batch(
                    *args, **kw), 3)
                tb_ms = _time_ms(torch, lambda: ba.traceback_batch(
                    k["bp"], lo, k["end_i"], k["end_j"], max_steps=steps), 3)
                finite = int((k["dist"] < 1 << 20).sum())
                shapes[(W, mode, bq)] = dict(
                    wf_ms=wf_ms, wf_plain_ms=plain_ms, tb_ms=tb_ms,
                    tb_plain_ms=plain_tb_ms, wf_err=wf_err, tb_err=tb_err,
                    wf_work=bench.wavefront_work(
                        n, m, Dmax=Dmax, W=W, LQG=qg.shape[1],
                        LTG=trg.shape[1]),
                    tb_work=bench.traceback_work(n_moves, P=P,
                                                 max_steps=steps))
                print(f"[3 parity] W={W} {mode} bq={bq} bt={bt} Dmax={Dmax}"
                      f" finite={finite}/{P} exact | wavefront {wf_ms:.3f} ms"
                      f" (plain {plain_ms:.1f} ms) | traceback {tb_ms:.3f} ms"
                      f" (plain {plain_tb_ms:.1f} ms)", flush=True)
    return shapes


def _bar(torch, k, p):
    """(max abs err, max rel err) of kernel k against plain p, and whether
    every element is within |k - p| <= 1e-3 * max(1, |p|)."""
    k = k.double()
    p = p.double()
    err = (k - p).abs()
    rel = err / p.abs().clamp(min=1.0)
    return float(err.max()), float(rel.max()), bool((rel <= 1e-3).all())


def _windows(np, rng, P, win, tlen):
    """P seeded (read, template) pairs: template of tlen (lo, hi) bases,
    half the reads exact copies, half at 15% error, cut to win.  Returns
    PAD-filled int8 (P, win) reads and (P, win) templates and lengths."""
    from falcon_unzip_tpu_torch.utils.simulate import (mutate_read,
                                                       random_genome)
    qs, ts = [], []
    for k in range(P):
        t = random_genome(int(rng.integers(*tlen)), int(rng.integers(1 << 30)))
        err = 0.0 if k % 2 == 0 else 0.15
        qs.append(mutate_read(t, err, rng)[:win])
        ts.append(t)
    q, n = _padded(np, qs, win)
    t, m = _padded(np, ts, win)
    return q, n, t, m


def phase_parity_hmm(torch, np) -> dict:
    """Pair-HMM forward kernel against pairhmm_forward_plain on the card
    at the bench shape (P=256, 512 bp windows, Dmax 1025)."""
    from falcon_unzip_tpu_torch import bench
    from falcon_unzip_tpu_torch.ops import banded_align as ba
    from falcon_unzip_tpu_torch.ops import pairhmm as ph
    dev = torch.device("cuda")
    rng = np.random.default_rng(2025)
    P, WIN = 256, 512
    q, n, t, m = _windows(np, rng, P, WIN, (400, 501))
    pvec = ph.params_vector()
    res = {}
    for W in (64, 128, 256):
        qg, trg, G = ba.prepare_batch(q, t, W)
        Dmax, lo = ba.build_schedule(WIN, WIN, W)
        args = (torch.from_numpy(qg).to(dev), torch.from_numpy(trg).to(dev),
                torch.from_numpy(n).to(dev), torch.from_numpy(m).to(dev), lo,
                pvec)
        kw = dict(W=W, Lt=WIN, G=G)
        k = ph.pairhmm_forward(*args, **kw)
        t0 = time.perf_counter()
        p = ph.pairhmm_forward_plain(*args, **kw)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        if not torch.equal(k <= -1e29, p <= -1e29):
            _fail(f"pairhmm W={W}: kernel and plain leave the band at "
                  "different pairs")
        ok = p > -1e29
        err, rel, within = _bar(torch, k[ok], p[ok])
        if not within or not bool(torch.isfinite(k).all()):
            _fail(f"pairhmm W={W}: max abs err {err} rel {rel} over the bar")
        ms = _time_ms(torch, lambda: ph.pairhmm_forward(*args, **kw), 5)
        res[W] = dict(ms=ms, plain_ms=plain_ms, err=err, rel=rel,
                      work=bench.pairhmm_work(n, m, Dmax=Dmax, W=W,
                                              LQG=qg.shape[1],
                                              LTG=trg.shape[1]))
        print(f"[3 parity] pairhmm_forward W={W} P={P} win={WIN} Dmax={Dmax}"
              f" in-band {int(ok.sum())}/{P} | max abs err {err:.3g} rel "
              f"{rel:.3g} (bar 1e-3) | kernel {ms:.3f} ms (plain "
              f"{plain_ms:.1f} ms)", flush=True)
    return res


def phase_parity_arrow(torch, np) -> dict:
    """Arrow splice sweep kernel against arrow_splice_plain on the card at
    the production polish shape (P=512, Lq=LJ=640, C=4)."""
    from falcon_unzip_tpu_torch import bench
    from falcon_unzip_tpu_torch.models.polisher import (PolisherConfig,
                                                         tier_table)
    from falcon_unzip_tpu_torch.ops import arrow as ar
    from falcon_unzip_tpu_torch.ops import pairhmm as ph
    dev = torch.device("cuda")
    rng = np.random.default_rng(2026)
    pc = PolisherConfig()
    P, L, C = pc.splice_chunk, pc.len_cap(), pc.arrow_candidates
    q, n, t, m = _windows(np, rng, P, L, (300, 421))
    cand = np.full((P, C), -1, np.int32)
    for k in range(P):
        cols = rng.choice(int(m[k]), size=C, replace=False)
        cols[0] = m[k] - 1                         # the terminal deletion
        cand[k, : 1 + k % C] = cols[: 1 + k % C]   # and unused slots
    pvec = np.tile(ph.params_vector(), (P, 1))
    tiers = tier_table()
    qt = rng.integers(0, len(tiers), size=(P, L + 1)).astype(np.int8)
    dt = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    res = {}
    for mode in ("per-pair", "per-base"):
        args = [dt(x) for x in (q, t, n, m, cand, pvec)]
        args += ([dt(qt), dt(tiers)] if mode == "per-base" else [None, None])
        k_cur, k_mut = ar.arrow_splice(*args, C=C)
        t0 = time.perf_counter()
        p_cur, p_mut = ar.arrow_splice_plain(*args, C=C)
        torch.cuda.synchronize()
        plain_all_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        ar.arrow_sweeps_plain(*args, C=C)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        k_all = torch.cat([k_cur[:, None], k_mut.reshape(P, -1)], dim=1)
        p_all = torch.cat([p_cur[:, None], p_mut.reshape(P, -1)], dim=1)
        if not torch.equal(k_all <= -1e29, p_all <= -1e29):
            _fail(f"arrow {mode}: kernel and plain disagree on NEG slots")
        ok = p_all > -1e29
        err, rel, within = _bar(torch, k_all[ok], p_all[ok])
        if not within or not bool(torch.isfinite(k_all).all()):
            _fail(f"arrow {mode}: max abs err {err} rel {rel} over the bar")
        ms = _time_ms(torch, lambda: ar.arrow_sweeps(*args, C=C), 5)
        all_ms = _time_ms(torch, lambda: ar.arrow_splice(*args, C=C), 5)
        res[mode] = dict(ms=ms, plain_ms=plain_ms, err=err, rel=rel,
                         work=bench.arrow_work(n, m, Lq=L, LJ=L, C=C))
        print(f"[3 parity] arrow_splice {mode} P={P} Lq=LJ={L} C={C} | "
              f"{int(ok.sum())} scores, max abs err {err:.3g} rel {rel:.3g}"
              f" (bar 1e-3) | sweep kernel {ms:.3f} ms (plain sweeps "
              f"{plain_ms:.1f} ms) | with splice assembly {all_ms:.3f} ms "
              f"(plain {plain_all_ms:.1f} ms)", flush=True)
    return res


def phase_parity_ablate(torch, smi) -> dict:
    """Pair-HMM step ablation kernel against pairhmm_ablate_plain on the
    card at the constants of the ablation script, every feature set, at
    two inputs: the script's (state planes NEG: out is NEG everywhere),
    equal; and the probe (seeded state planes, rows of N with two bases),
    where every set gives its own out: the sets without the logaddexps
    equal, those with them within 1e-5 relative.  Each set is timed from
    the NEG start and from a seeded one."""
    from falcon_unzip_tpu_torch.ops import pairhmm_ablate as pa
    from falcon_unzip_tpu_torch.scripts import ablate_pairhmm as ab
    dt = lambda x: torch.from_numpy(x).to("cuda")
    qg = dt(ab.rows())
    neg = dt(pa.neg_init(ab.P, ab.W))
    seeded = dt(pa.seeded_init(ab.P, ab.W, 0))
    probe_q, probe_i = (dt(x) for x in pa.probe_inputs(ab.P, ab.LQG, ab.W, 1))
    res, probe_outs = {}, []
    for feats in pa.FEATURE_SETS:
        k = pa.pairhmm_ablate(qg, neg, feats, Dmax=ab.Dmax)
        t0 = time.perf_counter()
        p = pa.pairhmm_ablate_plain(qg, neg, feats, Dmax=ab.Dmax)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        if not torch.equal(k, p):
            _fail(f"pairhmm_ablate {feats} from NEG: kernel and plain differ")
        k = pa.pairhmm_ablate(probe_q, probe_i, feats, Dmax=ab.Dmax)
        p = pa.pairhmm_ablate_plain(probe_q, probe_i, feats, Dmax=ab.Dmax)
        if not bool((p > -1e29).all()) or not bool(torch.isfinite(k).all()):
            _fail(f"pairhmm_ablate {feats}: probe output not finite")
        err = float((k.double() - p.double()).abs().max())
        rel = float(((k.double() - p.double()).abs()
                     / p.double().abs().clamp_min(1e-30)).max())
        if ("lse" in feats and rel > 1e-5) or \
                ("lse" not in feats and not torch.equal(k, p)):
            _fail(f"pairhmm_ablate {feats} at the probe: max abs err {err} "
                  f"rel {rel}")
        probe_outs.append(k)
        ms = _time_ms(torch, lambda: pa.pairhmm_ablate(
            qg, neg, feats, Dmax=ab.Dmax), 20)
        ms_seeded = _time_ms(torch, lambda: pa.pairhmm_ablate(
            qg, seeded, feats, Dmax=ab.Dmax), 20)
        res[feats] = dict(ms=ms, ms_seeded=ms_seeded, plain_ms=plain_ms,
                          err=err)
        print(f"[3 parity] pairhmm_ablate {feats} P={ab.P} W={ab.W} "
              f"Dmax={ab.Dmax} LQG={ab.LQG} | from NEG equal | at the probe "
              f"max abs err {err:.3g} rel {rel:.3g} (bar "
              f"{'1e-5 rel' if 'lse' in feats else '0'}) | kernel {ms:.4f} "
              f"ms, {1e3 * ms / ab.Dmax:.4f} us/step from NEG, "
              f"{ms_seeded:.4f} ms, {1e3 * ms_seeded / ab.Dmax:.4f} us/step "
              f"from the seeded start (plain {plain_ms:.1f} ms) | {smi}",
              flush=True)
    for a in range(len(probe_outs)):
        for b in range(a):
            if torch.equal(probe_outs[a], probe_outs[b]):
                _fail("pairhmm_ablate: two feature sets give the same out "
                      "at the probe")
    return res


GOLDEN = {"3-unzip/all_p_ctg.fa": "2864673ab4dc9bf2",
          "3-unzip/all_h_ctg.fa": "70b2521a58bd85f1",
          "3-unzip/all_phased_reads": "3c3f04ee8364d5f6",
          "4-polish/cns_p_ctg.fasta": "2864673ab4dc9bf2",
          "4-polish/cns_h_ctg.fasta": "70b2521a58bd85f1"}


def _decode(codes) -> str:
    """int8 base codes (A C G T N = 0..4) -> ASCII."""
    import numpy as np
    return np.frombuffer(b"ACGTN", np.uint8)[codes].tobytes().decode()


def _write_fasta(path, records) -> None:
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), 80):
                fh.write(seq[i : i + 80] + "\n")


def _read_fasta(np, path) -> list:
    """[(name, int8 base codes)] of a FASTA file (A C G T = 0..3, else 4)."""
    lut = np.full(256, 4, np.int8)
    for k, c in enumerate(b"ACGT"):
        lut[c] = k
    recs = []
    with open(path) as fh:
        for ln in fh:
            if ln.startswith(">"):
                recs.append((ln[1:].split()[0], []))
            else:
                recs[-1][1].append(ln.strip())
    return [(nm, lut[np.frombuffer("".join(parts).encode(), np.uint8)])
            for nm, parts in recs]


def _fasta_lengths(path) -> list:
    lens = []
    with open(path) as fh:
        for ln in fh:
            if ln.startswith(">"):
                lens.append(0)
            else:
                lens[-1] += len(ln.strip())
    return lens


def _write_inputs(d, draft, preads, raw) -> None:
    """draft: [(name, Diploid)]; preads / raw: [(name_prefix, SeqBatch)]."""
    for fn, reads in (("preads.fa", preads), ("raw.fa", raw)):
        _write_fasta(f"{d}/{fn}",
                     ((pre + b.names[i], b.to_str(i)) for pre, b in reads
                      for i in range(len(b))))
    _write_fasta(f"{d}/draft.fa",
                 [(name, _decode(dip.hap0)) for name, dip in draft])
    with open(f"{d}/run.json", "w") as fh:
        json.dump({"preads": f"{d}/preads.fa", "reads": f"{d}/raw.fa",
                   "draft": f"{d}/draft.fa", "out_dir": f"{d}/out"}, fh)


def _cli(d, cmd) -> None:
    """One stage on the card through the port's command line."""
    from falcon_unzip_tpu_torch.cli import main as cli_main
    if cli_main([cmd, f"{d}/run.json", "--device", "cuda"]) != 0:
        _fail(f"{cmd} exited non-zero in {d}")


def _launches(kernels):
    return {k.name: k.launches for k in kernels}


def phase_golden(tmp) -> str:
    from falcon_unzip_tpu_torch.ops import _kernels
    from falcon_unzip_tpu_torch.utils.simulate import (make_diploid,
                                                       simulate_reads)
    d = os.path.join(tmp, "golden")
    os.makedirs(d)
    dip = make_diploid(length=6000, het_rate=0.02, seed=77,
                       het_span=(0.3, 0.7))
    pr = simulate_reads(dip, coverage=14.0, read_len=1800, error_rate=0.0,
                        seed=78)
    raw = simulate_reads(dip, coverage=16.0, read_len=1500, error_rate=0.03,
                         seed=79)
    # the golden draft is named d0 (tests/test_golden.py)
    _write_inputs(d, [("d0", dip)], [("", pr.batch)], [("", raw.batch)])
    align = (_kernels.WAVEFRONT, _kernels.TRACEBACK)
    _kernels.reset_counts()
    t0 = time.perf_counter()
    _cli(d, "unzip")
    unzip_s = time.perf_counter() - t0
    unzip_launches = _launches(align)
    _kernels.reset_counts()
    t0 = time.perf_counter()
    _cli(d, "quiver")
    quiver_s = time.perf_counter() - t0
    quiver_launches = _launches(align + (_kernels.ARROW,))
    got = {}
    for rel, want in GOLDEN.items():
        with open(f"{d}/out/{rel}", "rb") as fh:
            got[rel] = hashlib.sha256(fh.read()).hexdigest()[:16]
        if got[rel] != want:
            _fail(f"golden {rel}: got {got[rel]}, want {want}")
    if min(unzip_launches.values()) <= 0:
        _fail(f"golden unzip did not launch both DP kernels: "
              f"{unzip_launches}")
    if min(quiver_launches[k.name] for k in align) <= 0:
        _fail(f"golden quiver did not align on the card: {quiver_launches}")
    n_qv = _fastq_vs_cpu(d)
    print(f"[4 golden] unzip {unzip_s:.1f} s, quiver {quiver_s:.1f} s | "
          f"hashes match {got} | launches unzip {unzip_launches}, quiver "
          f"{quiver_launches} | cns fastq vs the CPU run: sequences equal, "
          f"{n_qv} per-base QVs differ (by at most 1)", flush=True)
    return d


def _fastq_records(path) -> list:
    with open(path) as fh:
        lines = fh.read().splitlines()
    return list(zip(lines[1::4], lines[3::4]))


def _fastq_vs_cpu(d) -> int:
    """4-polish again with the plain torch versions on the CPU (whose
    outputs equal the JAX package's, tests/test_torch_polish.py) over the
    same 3-unzip/; the card's cns_*.fastq must carry the same sequences
    and QVs within 1.  Returns the number of QVs that differ."""
    from falcon_unzip_tpu_torch.cli import main as cli_main
    cpu = os.path.join(d, "cpu")
    shutil.copytree(f"{d}/out/3-unzip", f"{cpu}/out/3-unzip")
    with open(f"{d}/run.json") as fh:
        run = json.load(fh)
    run["out_dir"] = f"{cpu}/out"
    with open(f"{cpu}/run.json", "w") as fh:
        json.dump(run, fh)
    if cli_main(["quiver", f"{cpu}/run.json", "--device", "cpu"]) != 0:
        _fail("quiver on the CPU exited non-zero")
    n_diff = 0
    for stem in ("cns_p_ctg", "cns_h_ctg"):
        card = _fastq_records(f"{d}/out/4-polish/{stem}.fastq")
        host = _fastq_records(f"{cpu}/out/4-polish/{stem}.fastq")
        if [r[0] for r in card] != [r[0] for r in host]:
            _fail(f"{stem}.fastq: card and CPU sequences differ")
        for (_, qa), (_, qb) in zip(card, host):
            diff = [abs(ord(a) - ord(b)) for a, b in zip(qa, qb)]
            if diff and max(diff) > 1:
                _fail(f"{stem}.fastq: a QV differs by {max(diff)}")
            n_diff += sum(1 for x in diff if x)
    return n_diff


class _PlainScorer:
    """PairHMMScorer's interface over pairhmm_forward_plain on the card."""

    def __init__(self, torch, W):
        from falcon_unzip_tpu_torch.ops.pairhmm import params_vector
        self.torch = torch
        self.W = W
        self.pvec = params_vector()

    def __call__(self, q, t, n, m):
        import numpy as np
        from falcon_unzip_tpu_torch.ops import banded_align as ba
        from falcon_unzip_tpu_torch.ops.pairhmm import pairhmm_forward_plain
        qg, trg, G = ba.prepare_batch(q, t, self.W)
        _, lo = ba.build_schedule(q.shape[1], t.shape[1], self.W)
        dt = lambda x: self.torch.from_numpy(
            np.ascontiguousarray(x)).to("cuda")
        return pairhmm_forward_plain(
            dt(qg), dt(trg), dt(n.astype(np.int32)), dt(m.astype(np.int32)),
            lo, self.pvec, W=self.W, Lt=t.shape[1], G=G).cpu().numpy()


def phase_reforward(torch, np, d) -> dict:
    """Re-forward polish through the pair-HMM kernel on the golden
    fixture's contigs and raw-read AlnSet, against the same polish with
    the scorer's plain version, and the oracle window."""
    from falcon_unzip_tpu_torch.models.aligner import AlnSet
    from falcon_unzip_tpu_torch.models.polisher import (Polisher,
                                                         PolisherConfig,
                                                         _WinState)
    from falcon_unzip_tpu_torch.ops import _kernels
    from falcon_unzip_tpu_torch.ops.pairhmm import PairHMMScorer
    from falcon_unzip_tpu_torch.oracle.hmm import polish_window_oracle
    from falcon_unzip_tpu_torch.utils.simulate import (mutate_read,
                                                       random_genome)
    contigs = []
    for fn in ("all_p_ctg.fa", "all_h_ctg.fa"):
        contigs += _read_fasta(np, f"{d}/out/3-unzip/{fn}")
    with open(f"{d}/out/4-polish/1-track/aln_set.msgpack", "rb") as fh:
        aln = AlnSet.from_bytes(fh.read())
    W = 128
    # margin_frac > 1 makes every covered column a candidate, so every
    # window with enough reads scores its mutations through the scorer
    pcfg = PolisherConfig(margin_frac=1.01)
    _kernels.reset_counts()
    t0 = time.perf_counter()
    got = Polisher(pcfg, scorer=PairHMMScorer(
        W=W, device="cuda")).polish_all(contigs, aln)
    kernel_s = time.perf_counter() - t0
    launches = _kernels.PAIRHMM.launches
    cells = _kernels.PAIRHMM.cells
    t0 = time.perf_counter()
    want = Polisher(pcfg, scorer=_PlainScorer(torch, W)
                    ).polish_all(contigs, aln)
    plain_s = time.perf_counter() - t0
    if launches <= 0:
        _fail("the re-forward polish did not launch the pair-HMM kernel")
    for a, b in zip(got, want):
        if not np.array_equal(a.seq, b.seq):
            _fail(f"re-forward polish of {a.name}: kernel and plain "
                  "consensus differ")
    # the window of tests/test_polisher.py::test_arrow_matches_window_oracle
    rng = np.random.default_rng(7)
    truth = random_genome(48, 7)
    draft = truth.copy()
    draft[10] = (draft[10] + 1) % 4
    draft[30] = (draft[30] + 2) % 4
    reads = [mutate_read(truth, 0.03, rng) for _ in range(8)]
    ref = polish_window_oracle(draft, reads, [10, 30], max_rounds=8)
    st = _WinState(cns=draft.copy(), votes=np.zeros((48, 9, 5), np.int32),
                   segs=reads, active=True, cand=[10, 30])
    Polisher(PolisherConfig(arrow_rounds=8),
             scorer=PairHMMScorer(W=W, device="cuda"))._refine_windows([st])
    if not (np.array_equal(st.cns, ref) and np.array_equal(st.cns, truth)):
        _fail("re-forward window differs from polish_window_oracle")
    n_bp = sum(len(c.seq) for c in got)
    print(f"[4b reforward] {len(got)} contigs, {n_bp} bp | kernel run "
          f"{kernel_s:.1f} s, {launches} pair-HMM launches, {cells} band "
          f"cells | plain run {plain_s:.1f} s | consensus equal | oracle "
          f"window equal", flush=True)
    return {"launches": launches}


def _n50_lengths(genome_bp):
    """scripts/e2e_bench.py::contig_lengths, profile n50."""
    fr = [0.5, 0.2, 0.1, 0.065, 0.065, 0.07]
    lens = [int(genome_bp * f) for f in fr[:-1]]
    return lens + [genome_bp - sum(lens)]


def _stats(lens) -> dict:
    lens = sorted(lens, reverse=True)
    total, acc, n50 = sum(lens), 0, 0
    for x in lens:
        acc += x
        if 2 * acc >= total:
            n50 = x
            break
    return {"n_seqs": len(lens), "total_bp": total, "n50": n50,
            "max_len": lens[0] if lens else 0}


def _stage_rows(path, skip: int = 0) -> dict:
    """{stage: row} of the timed rows of metrics.jsonl after line skip."""
    stages = {}
    with open(path) as fh:
        for ln in list(fh)[skip:]:
            row = json.loads(ln)
            if "s" in row:
                row.pop("ts")
                stages[row.pop("stage")] = row
    return stages


def _timed_run(torch, d, cmd, kernels) -> tuple:
    """One stage of the main path with the counts set to 0 just before it
    and read just after; returns (wall s, launches, device ms, cells)."""
    from falcon_unzip_tpu_torch.ops import _kernels
    for k in _kernels.KERNELS:
        k.timed = True
    _kernels.reset_counts()
    t0 = time.perf_counter()
    _cli(d, cmd)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(kernels)
    dev_ms = {k.name: k.elapsed_ms() for k in kernels}
    cells = {k.name: k.cells for k in kernels}
    for k in _kernels.KERNELS:
        k.timed = False
    return wall, launches, dev_ms, cells


def phase_main(torch, tmp, genome_bp) -> dict:
    from falcon_unzip_tpu_torch.ops import _kernels
    from falcon_unzip_tpu_torch.utils.simulate import (make_diploid,
                                                       simulate_reads)
    d = os.path.join(tmp, "main")
    os.makedirs(d)
    t0 = time.perf_counter()
    draft, preads, raw = [], [], []
    for ci, per in enumerate(_n50_lengths(genome_bp)):
        dip = make_diploid(length=per, het_rate=0.012, seed=100 + ci,
                           het_span=(0.2, 0.8))
        pr = simulate_reads(dip, coverage=25.0, read_len=2200,
                            error_rate=0.0, seed=200 + ci)
        rw = simulate_reads(dip, coverage=29.0, read_len=1800,
                            error_rate=0.03, seed=300 + ci)
        draft.append((f"draft{ci}", dip))
        preads.append((f"c{ci}/", pr.batch))
        raw.append((f"c{ci}/", rw.batch))
    _write_inputs(d, draft, preads, raw)
    n_preads = sum(len(b) for _, b in preads)
    n_raw = sum(len(b) for _, b in raw)
    sim_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    align = (_kernels.WAVEFRONT, _kernels.TRACEBACK)
    unzip_s, u_launch, u_ms, u_cells = _timed_run(torch, d, "unzip", align)
    p_ctg = _stats(_fasta_lengths(f"{d}/out/3-unzip/all_p_ctg.fa"))
    h_ctg = _stats(_fasta_lengths(f"{d}/out/3-unzip/all_h_ctg.fa"))
    with open(f"{d}/out/3-unzip/all_phased_reads") as fh:
        n_phased = sum(1 for _ in fh)
    rate = (u_cells["banded_wavefront"]
            / max(u_ms["banded_wavefront"], 1e-9) / 1e6)
    stages = _stage_rows(f"{d}/out/metrics.jsonl")
    with open(f"{d}/out/metrics.jsonl") as fh:
        n_rows = sum(1 for _ in fh)
    print(f"[5 main unzip] genome {genome_bp} bp n50 profile, {n_preads} "
          f"preads 25x | sim {sim_s:.1f} s | unzip {unzip_s:.1f} s | stages"
          f" {stages} | launches {u_launch} | DP cells "
          f"{u_cells['banded_wavefront']} | kernel device ms {u_ms} | "
          f"{rate:.2f} Gcell/s in the wavefront kernel | p_ctg {p_ctg} | "
          f"h_ctg {h_ctg} | phased reads {n_phased}", flush=True)
    quiver_s, q_launch, q_ms, q_cells = _timed_run(
        torch, d, "quiver", align + (_kernels.ARROW,))
    peak = torch.cuda.max_memory_allocated()
    q_stages = _stage_rows(f"{d}/out/metrics.jsonl", n_rows)
    cns_p = _stats(_fasta_lengths(f"{d}/out/4-polish/cns_p_ctg.fasta"))
    cns_h = _stats(_fasta_lengths(f"{d}/out/4-polish/cns_h_ctg.fasta"))
    with open(f"{d}/out/4-polish/2-polish/stage.done.json") as fh:
        mean_qv = json.load(fh).get("metrics", {}).get("mean_qv")
    print(f"[5 main quiver] {n_raw} raw reads 29x 3% error | quiver "
          f"{quiver_s:.1f} s | stages {q_stages} | launches {q_launch} | "
          f"kernel device ms {q_ms} | splice rows x columns "
          f"{q_cells['arrow_splice']} | mean_qv {mean_qv} | cns_p {cns_p} |"
          f" cns_h {cns_h} | peak device memory {peak / 2**30:.3f} GiB",
          flush=True)
    if p_ctg["total_bp"] < 0.9 * genome_bp:
        _fail(f"primary bp {p_ctg['total_bp']} < 90% of {genome_bp}")
    if h_ctg["n_seqs"] < 1:
        _fail("no haplotig")
    if n_phased == 0:
        _fail("all_phased_reads is empty")
    if min(u_launch.values()) <= 0:
        _fail(f"main unzip did not launch every DP kernel: {u_launch}")
    if cns_p["total_bp"] < 0.9 * genome_bp:
        _fail(f"polished primary bp {cns_p['total_bp']} < 90% of "
              f"{genome_bp}")
    if min(q_launch.values()) <= 0:
        _fail(f"main quiver did not launch every kernel: {q_launch}")
    return {"launches": {**u_launch, "arrow_splice":
                         q_launch["arrow_splice"]}}


def phase_ablate_path() -> dict:
    """The ablation script's entry point with the counts set to 0 just
    before it and read just after."""
    from falcon_unzip_tpu_torch.ops import _kernels
    from falcon_unzip_tpu_torch.scripts import ablate_pairhmm
    _kernels.reset_counts()
    rows = ablate_pairhmm.main()
    launches = _kernels.ABLATE.launches
    if launches <= 0 or len(rows) != 5:
        _fail(f"the ablation script launched its kernel {launches} times "
              f"over {len(rows)} feature sets")
    print(f"[6 ablate] {len(rows)} feature sets, {launches} kernel launches",
          flush=True)
    return {"launches": launches}


def phase_bench() -> dict:
    """The kernel bench through the port's command line, counts set to 0
    just before it and read just after; its JSON line printed as it is."""
    from falcon_unzip_tpu_torch.cli import main as cli_main
    from falcon_unzip_tpu_torch.ops import _kernels
    kernels = (_kernels.PAIRHMM, _kernels.ARROW, _kernels.WAVEFRONT)
    _kernels.reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli_main(["bench"])
    launches = _launches(kernels)
    line = buf.getvalue().strip().splitlines()[-1]
    print(line, flush=True)
    res = json.loads(line)
    if code != 0 or min(launches.values()) <= 0:
        _fail(f"bench exited {code} with launches {launches}")
    rates = ("value", "gcells_per_sec", "pct_fp32_peak",
             "splice_mutations_per_sec", "splice_pairs_per_sec",
             "editdp_gcells_per_sec")
    if not all(isinstance(res[k], float) and res[k] > 0 for k in rates):
        _fail(f"bench rates not positive: {res}")
    print(f"[7 bench] launches {launches}", flush=True)
    return res


def _entry(name, source, replaces, launches, err, ms, plain_ms, work):
    """One kernel of the kernels line; its bound from this run's work."""
    from falcon_unzip_tpu_torch import bench
    bound, by = bench.bound_ms(work["ops"], work["bytes"], work["peak"])
    return {"name": name, "route": "cuda",
            "source": "falcon_unzip_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-bp", type=int, default=1_000_000)
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "falcon_unzip_tpu_torch")):
        _fail("run from a checkout: falcon_unzip_tpu_torch/ is not beside "
              "this script")
    sys.path.insert(0, here)
    import numpy as np
    import torch

    smi = phase_card(torch)
    phase_build()
    shapes = phase_parity_align(torch, np)
    hmm = phase_parity_hmm(torch, np)
    arrow = phase_parity_arrow(torch, np)
    ablate = phase_parity_ablate(torch, smi)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        golden_dir = phase_golden(tmp)
        reforward = phase_reforward(torch, np, golden_dir)
        main_run = phase_main(torch, tmp, args.genome_bp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ablate_run = phase_ablate_path()
    phase_bench()
    from falcon_unzip_tpu_torch import bench
    from falcon_unzip_tpu_torch.scripts import ablate_pairhmm as ab
    at = shapes[(256, "tglocal", 2048)]
    full = ("shift", "load", "lse")
    kernels = [
        _entry("banded_wavefront", "banded_align.cu",
               "falcon_unzip_tpu/ops/pallas_align.py:41",
               main_run["launches"]["banded_wavefront"],
               max(v["wf_err"] for v in shapes.values()), at["wf_ms"],
               at["wf_plain_ms"], at["wf_work"]),
        _entry("traceback", "banded_align.cu",
               "falcon_unzip_tpu/ops/banded_align.py:180",
               main_run["launches"]["traceback"],
               max(v["tb_err"] for v in shapes.values()), at["tb_ms"],
               at["tb_plain_ms"], at["tb_work"]),
        _entry("pairhmm_forward", "pairhmm.cu",
               "falcon_unzip_tpu/ops/pallas_pairhmm.py:41",
               reforward["launches"], max(v["err"] for v in hmm.values()),
               hmm[128]["ms"], hmm[128]["plain_ms"], hmm[128]["work"]),
        _entry("arrow_splice", "arrow_splice.cu",
               "falcon_unzip_tpu/ops/arrow.py:88",
               main_run["launches"]["arrow_splice"],
               max(v["err"] for v in arrow.values()),
               arrow["per-pair"]["ms"], arrow["per-pair"]["plain_ms"],
               arrow["per-pair"]["work"]),
        _entry("pairhmm_ablate", "pairhmm_ablate.cu",
               "scripts/ablate_pallas.py:17", ablate_run["launches"],
               max(v["err"] for v in ablate.values()), ablate[full]["ms"],
               ablate[full]["plain_ms"],
               bench.ablate_work(full, P=ab.P, Dmax=ab.Dmax, W=ab.W,
                                 LQG=ab.LQG)),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
