"""The shared test data and checks of utils/fixtures.py.

``edit_identity`` (the independent identity score of chip_smoke.py's
FalconSense phase) equals a per-cell Python edit distance with free truth
ends; ``mutate`` keeps the error model of utils.simulate.mutate_read;
``run_artifacts`` drops only the stage markers' run-specific fields.
"""
import json

import numpy as np
import pytest
import torch

from falcon_unzip_tpu_torch.utils import fixtures as fx
from falcon_unzip_tpu_torch.utils.simulate import random_genome

torch.set_num_threads(1)


def _semiglobal(q, t):
    """Unit-cost edit distance of all of q to any substring of t."""
    prev = [0] * (len(t) + 1)
    for i in range(1, len(q) + 1):
        cur = [i] + [0] * len(t)
        for j in range(1, len(t) + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (q[i - 1] != t[j - 1]))
        prev = cur
    return min(prev)


@pytest.mark.parametrize("seed,rate", [(1, 0.0), (2, 0.01), (3, 0.05)])
def test_edit_identity_equals_python_dp(seed, rate):
    truth = random_genome(1500, seed)
    cns = fx.mutate(np.random.default_rng(seed), truth, rate)
    got = fx.edit_identity(cns, truth, "cpu", piece=300, margin=40, k=16)
    cuts = list(range(0, len(cns), 300))
    if len(cns) - cuts[-1] < 150:
        cuts.pop()
    pieces = [cns[a:b] for a, b in zip(cuts, cuts[1:] + [len(cns)])]
    want = [_semiglobal(p.tolist(), truth.tolist()) for p in pieces]
    assert got["unplaced"] == 0 and got["pieces"] == len(pieces)
    assert got["dist"] == want
    assert got["placed"] == len(cns)
    assert got["identity"] == pytest.approx(1 - sum(want) / len(cns))
    if rate == 0:
        assert got["identity"] == 1.0


def test_edit_identity_places_no_unrelated_piece():
    # a tail of 100 bases joins the third piece
    got = fx.edit_identity(random_genome(1000, 5), random_genome(3000, 6),
                           "cpu", piece=300, margin=40, k=16)
    assert got == {"identity": 0.0, "placed": 0, "pieces": 3,
                   "unplaced": 3, "dist": []}


def test_mutate_error_mix():
    """Insertions balance deletions, and the edit distance to the source
    is close to the rate; rate 0 copies."""
    seq = random_genome(200_000, 0)
    out = fx.mutate(np.random.default_rng(0), seq, 0.3)
    assert abs(len(out) - len(seq)) < 0.01 * len(seq)
    seq = random_genome(3000, 1)
    got = fx.edit_identity(fx.mutate(np.random.default_rng(1), seq, 0.09),
                           seq, "cpu", piece=300, margin=40, k=12)
    assert got["unplaced"] == 0 and 0.07 < 1 - got["identity"] < 0.095
    same = fx.mutate(np.random.default_rng(0), seq, 0.0)
    assert np.array_equal(same, seq) and same.dtype == np.int8


def test_template_reads_spans():
    truth, template, reads, spans = fx.template_reads(30_000, 12, seed=4)
    assert len(reads) == 12 and len(truth) == 30_000
    assert abs(len(template) - len(truth)) < 0.01 * len(truth)
    for (s, e) in spans:
        assert 0 <= s < e <= 30_000 and 7000 <= e - s <= 13000


def test_run_artifacts_drop_run_fields(tmp_path):
    (tmp_path / "3-unzip").mkdir()
    (tmp_path / "4-polish").mkdir()
    (tmp_path / "3-unzip" / "a.fa").write_bytes(b">a\nACGT\n")
    (tmp_path / "4-polish" / "cns_p_ctg.fasta").write_bytes(b">a\nAC\n")
    (tmp_path / "4-polish" / "other").write_bytes(b"x")
    (tmp_path / "3-unzip" / "stage.done.json").write_text(json.dumps(
        {"stage": "unzip", "wall_s": 1.5, "fingerprint": "f"}))
    got = fx.run_artifacts(str(tmp_path))
    assert sorted(got) == ["3-unzip/a.fa", "3-unzip/stage.done.json",
                           "4-polish/cns_p_ctg.fasta"]
    assert json.loads(got["3-unzip/stage.done.json"]) == {"stage": "unzip"}
    assert fx.dir_bytes(str(tmp_path / "4-polish")) == {
        "cns_p_ctg.fasta": b">a\nAC\n", "other": b"x"}
