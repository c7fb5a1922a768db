"""The control of `correct` at a size a test run holds: the reference with
its DP in bfloat16 in the mapper's place fails the comparison that the
float32 reference passes, on both configurations' kinds of read."""

from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import check, control

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("cfg,ref", [("ecoli_r9_dna", {"bases": 6000}), ("sequin_r9_rna", {"count": 5})])
def test_lower_precision_fails_the_check(cfg, ref, tmp_path):
    c = json.load(open(os.path.join(BENCH, "configs", cfg + ".json")))
    c["reference"].update(ref)
    t = dict(json.load(open(os.path.join(BENCH, "traffic", "zlib.json"))), reads=40)
    for seed in (5, 2**31 + 11):
        same = control.control(c, t, seed, str(tmp_path), "cpu", torch.float32)
        low = control.control(c, t, seed, str(tmp_path), "cpu", torch.bfloat16)
        assert check.verdict(same) and same["wrong_lines"] == 0
        assert not check.verdict(low) and low["wrong_lines"] >= check.SAMPLE // 2
