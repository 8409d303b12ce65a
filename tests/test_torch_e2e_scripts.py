"""The port's e2e bench, QV calibration, QV attribution and 1-align
profile == the JAX package's scripts, on the CPU.

One run of each e2e bench (``scripts/e2e_bench.py`` under
``JAX_PLATFORMS=cpu``, and ``falcon_unzip_tpu_torch.scripts.e2e_bench
--device cpu``) at 20,001 bp n50 14x: six contigs of 1.3-10 kb, so the
twin's spawned simulation pool, its ordering and its ``c{ci}/`` read
names are held against the reference's FASTAs.  The reference scripts
hard-code their scratch directory under ``/tmp/``; each runs here from
its source with that prefix swapped, in memory, for a directory under
pytest's ``tmp_path``, so every artifact of both sides stays in this
run's own temporary tree.

* The two JSON lines are equal in every field but the times (``sim_s``,
  ``unzip_s``, ``polish_s``, ``total_s``, ``genome_bases_per_sec`` and
  every ``s`` / ``*_s`` of ``stage_metrics``) and the fields each package
  names its device and kernels by (``platform`` / ``n_pallas_shapes``
  against ``device`` / ``launches`` / ``device_ms``); the input FASTAs and
  the polished contigs are byte-identical.
* That consensus is exact, so a copy of it with seeded errors is scored
  too: substitutions and indels, one contig reverse-complemented, one
  500 bp chunk replaced by random sequence (unaligned) and one chunk
  whose tail is taken from the other haplotype (a switch).  On the copy
  ``_truth_qv`` (QV and breakdown), ``qv_calibrate``'s ``chunk_stats``
  rows and JSON, and ``qv_attrib``'s JSON are equal.
* ``profile_align``'s read and alignment counts are equal.
"""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from falcon_unzip_tpu_torch.io.fasta import write_fasta, write_fastq
from falcon_unzip_tpu_torch.scripts import e2e_bench, qv_calibrate
from falcon_unzip_tpu_torch.seq import decode

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BP, COV, PROFILE = 20_001, 14.0, "n50"
ARGS = [str(BP), str(COV), PROFILE]
# Runs a reference script as __main__ from its source, its scratch
# prefix f"/tmp/... (scripts/e2e_bench.py:170, qv_calibrate.py:91,
# qv_attrib.py:37) swapped for ROOT + f"/...; the file is not changed.
RUNNER = """
import sys
path, root = sys.argv[1], sys.argv[2]
with open(path) as fh:
    src = fh.read()
assert src.count('f"/tmp/e2e_bench_') <= 1
src = src.replace('f"/tmp/e2e_bench_', 'ROOT + f"/e2e_bench_')
sys.argv = [path] + sys.argv[3:]
exec(compile(src, path, "exec"),
     {"__name__": "__main__", "__file__": path, "ROOT": root})
"""
CNS = ("cns_p_ctg", "cns_h_ctg")
TIMES = {"sim_s", "unzip_s", "polish_s", "total_s", "genome_bases_per_sec"}
DEVICE_KEYS = {"platform", "n_pallas_shapes", "device", "launches",
               "device_ms"}
FILES = ("preads.fa", "raw.fa", "draft.fa", "out/4-polish/cns_p_ctg.fasta",
         "out/4-polish/cns_h_ctg.fasta", "out/4-polish/cns_p_ctg.fastq",
         "out/4-polish/cns_h_ctg.fastq")


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("E2E_KEEP", "E2E_PROFILE")}
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               **extra)
    return env


def _ref(script, root, *args, **env):
    return subprocess.Popen(
        [sys.executable, "-c", RUNNER, os.path.join(REPO, "scripts", script),
         root, *args], cwd=REPO, env=_env(**env), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _twin(name, *args):
    return subprocess.Popen(
        [sys.executable, "-m", f"falcon_unzip_tpu_torch.scripts.{name}",
         *args, "--device", "cpu"], cwd=REPO, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _last_lines(procs) -> list:
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=900)
        assert p.returncode == 0, err[-4000:]
        outs.append(out.strip().splitlines()[-1])
    return outs


def _load(script):
    spec = importlib.util.spec_from_file_location(
        f"ref_{script}", os.path.join(REPO, "scripts", f"{script}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both e2e benches and both 1-align profiles, side by side; the
    files to compare are read before the scoring tests overwrite the
    reference's consensus."""
    root = str(tmp_path_factory.mktemp("ref"))
    ref_dir = f"{root}/e2e_bench_{BP}_{PROFILE}"    # scripts/e2e_bench.py:170
    d = str(tmp_path_factory.mktemp("twin"))
    procs = [_ref("e2e_bench.py", root, *ARGS),
             _twin("e2e_bench", *ARGS, "--scratch", d),
             _ref("profile_align.py", root, str(BP), str(COV)),
             _twin("profile_align", str(BP), str(COV))]
    ref, twin, ref_prof, twin_prof = _last_lines(procs)
    files = {name: (_read(os.path.join(ref_dir, name)),
                    _read(os.path.join(d, name))) for name in FILES}
    return {"root": root, "ref_dir": ref_dir, "dir": d,
            "ref": json.loads(ref), "twin": json.loads(twin),
            "ref_prof": eval(ref_prof, {"nan": float("nan")}),
            "twin_prof": json.loads(twin_prof), "files": files}


def _untimed(row: dict) -> dict:
    return {k: v for k, v in row.items() if k != "s" and not k.endswith("_s")}


def test_e2e_json_equal_but_times(runs):
    ref, twin = runs["ref"], runs["twin"]
    assert twin["device"] == "cpu"
    assert set(ref) - DEVICE_KEYS == set(twin) - DEVICE_KEYS
    for k in set(ref) - DEVICE_KEYS - TIMES - {"stage_metrics"}:
        assert twin[k] == ref[k], k
    sm_ref, sm_twin = ref["stage_metrics"], twin["stage_metrics"]
    assert list(sm_twin) == list(sm_ref)
    for k in sm_ref:
        assert _untimed(sm_twin[k]) == _untimed(sm_ref[k]), k
    assert ref["truth_qv_p"] is not None and ref["qv_breakdown_h"]


@pytest.mark.parametrize("name", FILES)
def test_e2e_files_byte_identical(runs, name):
    ref, twin = runs["files"][name]
    assert len(twin) > 0 and twin == ref


def test_profile_align_counts_equal(runs):
    ref, twin = runs["ref_prof"], runs["twin_prof"]
    assert twin["device"] == "cpu" and twin["n_aligned"] > 0
    assert (twin["n_reads"], twin["n_aligned"]) == (ref["n_reads"],
                                                    ref["n_aligned"])


def _fastq(path) -> list:
    with open(path) as fh:
        lines = fh.read().splitlines()
    return [(lines[i][1:], lines[i + 1], lines[i + 3])
            for i in range(0, len(lines), 4)]


def _rc(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def _oriented(s: str, q: str, hap_strs) -> tuple:
    """(s, q) turned to the haplotypes' strand, and (hap, offset) of s."""
    for seq, qual in ((s, q), (_rc(s), q[::-1])):
        for h, hs in enumerate(hap_strs):
            at = hs.find(seq)
            if at >= 0:
                return seq, qual, h, at
    raise AssertionError("the fixture's contig is not a haplotype substring")


ACGT = np.frombuffer(b"ACGT", np.uint8)


def _substitute(rng, s, lo: int, n: int) -> None:
    for o in lo + rng.choice(500, n, replace=False):
        s[o] = ACGT[(np.flatnonzero(ACGT == s[o])[0] + rng.integers(1, 4))
                    % 4]


def _mutated(rng, rec, hap_strs, primary: bool) -> tuple:
    """A contig of the consensus with seeded errors.  Primary: chunk 10
    random, the first chunk from offset 4000 on with a het site in its
    first and in its last 150 bp given the other haplotype's last 250 bp,
    three substitutions in chunk 2, a base inserted in chunk 7 and one
    deleted in chunk 5 (the chunks after 7 keep their offsets).
    Haplotig: two substitutions in chunk 3, written reverse-complemented."""
    name, s, q, h, at = rec[0], *_oriented(rec[1], rec[2], hap_strs)
    s = np.frombuffer(s.encode(), np.uint8).copy()
    q = np.frombuffer(q.encode(), np.uint8).copy()
    if not primary:
        _substitute(rng, s, 1500, 2)
        return name, _rc(s.tobytes().decode()), q[::-1].tobytes().decode()
    mine = np.frombuffer(hap_strs[h].encode(), np.uint8)
    other = np.frombuffer(hap_strs[h ^ 1].encode(), np.uint8)
    het = np.flatnonzero(mine != other) - at
    sw = next(o for o in range(4000, len(s) - 500, 500)
              if o != 5000 and ((het >= o) & (het < o + 150)).any()
              and ((het >= o + 350) & (het < o + 500)).any())
    s[sw + 250 : sw + 500] = other[at + sw + 250 : at + sw + 500]
    s[5000:5500] = ACGT[rng.integers(0, 4, 500)]
    _substitute(rng, s, 1000, 3)
    ins = 3500 + int(rng.integers(100, 400))
    s, q = np.insert(s, ins, ACGT[rng.integers(0, 4)]), np.insert(q, ins,
                                                                  q[ins])
    cut = 2500 + int(rng.integers(100, 400))
    s, q = np.delete(s, cut), np.delete(q, cut)
    return name, s.tobytes().decode(), q.tobytes().decode()


@pytest.fixture(scope="module")
def mutated(runs, tmp_path_factory):
    """The consensus with seeded errors in its longest contig of each
    kind, written into a scratch directory of the port's scripts and over
    the reference's consensus; both
    packages' QV calibration and attribution of it, side by side."""
    d = str(tmp_path_factory.mktemp("mutated"))
    haps = e2e_bench.truth_haps(BP, PROFILE)
    hap_strs = [decode(h) for h in haps]
    rng = np.random.default_rng(11)
    for stem in CNS:
        recs = _fastq(f"{runs['dir']}/out/4-polish/{stem}.fastq")
        assert len(recs) >= 2
        top = max(range(len(recs)), key=lambda i: len(recs[i][1]))
        recs[top] = _mutated(rng, recs[top], hap_strs, stem == "cns_p_ctg")
        for root in (f"{d}/out/4-polish", f"{runs['ref_dir']}/out/4-polish"):
            write_fasta(f"{root}/{stem}.fasta", ((n, s) for n, s, _ in recs))
            write_fastq(f"{root}/{stem}.fastq", recs)
    procs = [_ref("qv_calibrate.py", runs["root"], *ARGS, QV_CAL_CPU="1"),
             _ref("qv_attrib.py", runs["root"], *ARGS, QV_CAL_CPU="1"),
             _twin("qv_calibrate", *ARGS, "--scratch", d),
             _twin("qv_attrib", *ARGS, "--scratch", d)]
    cal_ref, att_ref, cal_twin, att_twin = map(json.loads, _last_lines(procs))
    return {"dir": d, "ref_dir": runs["ref_dir"], "haps": haps,
            "cal": (cal_ref, cal_twin),
            "att": (att_ref, att_twin)}


@pytest.fixture(scope="module")
def scored(mutated):
    """{stem: ((ref QV, breakdown), (port QV, breakdown), ref chunk_stats,
    port chunk_stats)} on the consensus with errors."""
    ref_e2e, ref_cal = _load("e2e_bench"), _load("qv_calibrate")
    out = {}
    for stem in CNS:
        ref_fa = f"{mutated['ref_dir']}/out/4-polish/{stem}.fasta"
        fa = f"{mutated['dir']}/out/4-polish/{stem}.fasta"
        fq = fa[:-1] + "q"
        out[stem] = (
            ref_e2e._truth_qv(ref_fa, mutated["haps"]),
            e2e_bench._truth_qv(fa, mutated["haps"], device="cpu"),
            ref_cal.chunk_stats(ref_fa, ref_fa[:-1] + "q", mutated["haps"]),
            qv_calibrate.chunk_stats(fa, fq, mutated["haps"], device="cpu"))
    return out


def test_errors_reach_every_scoring_branch(scored):
    _, bd_p = scored["cns_p_ctg"][1]
    _, bd_h = scored["cns_h_ctg"][1]
    assert bd_p["n_switch"] >= 1 and bd_p["n_unaligned"] >= 1
    assert bd_p["n_interior"] >= 3 and bd_h["n_interior"] >= 1
    assert 0 < bd_p["n_exact"] < bd_p["n_chunks"]


@pytest.mark.parametrize("stem", CNS)
def test_truth_qv_equal_on_errors(scored, stem):
    ref, twin = scored[stem][:2]
    assert twin[0] < 60.0
    assert twin == ref


@pytest.mark.parametrize("stem", CNS)
def test_chunk_stats_equal_on_errors(scored, stem):
    ref, twin = scored[stem][2:]
    assert sum(obs for _, _, obs in twin) > 0
    assert twin == ref


def test_qv_calibrate_json_equal_on_errors(mutated):
    ref, twin = mutated["cal"]
    assert twin["total_observed"] > 0
    assert twin == ref


def test_qv_attrib_json_equal_on_errors(mutated):
    ref, twin = mutated["att"]
    assert twin["n_errors"] > 0 and twin["sample"]
    assert twin == ref


@pytest.mark.parametrize("name,argv", [
    ("e2e_bench", ["1000"]), ("qv_calibrate", ["1000"]),
    ("qv_attrib", ["1000"]), ("profile_align", ["1000"])])
def test_twins_default_to_cuda(monkeypatch, tmp_path, name, argv):
    """Without --device a twin asks for cuda, and raises without a GPU
    before it writes anything."""
    mod = importlib.import_module(f"falcon_unzip_tpu_torch.scripts.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scratch = ["--scratch", str(tmp_path / "s")] \
        if name != "profile_align" else []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv + scratch)
    assert not (tmp_path / "s").exists()
