"""The port's `eval` subcommand (sigfish_tpu_torch/eval.py, a copy of
sigfish_tpu/eval.py) against `python -m sigfish_tpu.cli eval`: the same
bytes over --secondary yes|no x --tid-only, through the library and the
CLI, and the same error for a mapq outside [0, 60].

Inputs: a truth PAF and a test PAF made from a seed, with reads mapped
twice in the truth (a primary and a secondary), secondary test records,
reads only in the test set, wrong strands and contigs, and offsets on
both sides of eval's 100-base threshold.
"""

from __future__ import annotations

import io
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMBOS = [(sec, tid) for sec in ("yes", "no") for tid in (False, True)]


def _paf(rid, strand, tid, st, en, mapq, tp):
    return (f"{rid}\t5000\t100\t4000\t{strand}\t{tid}\t30000\t{st}\t{en}\t{en - st}\t"
            f"{en - st}\t{mapq}\ttp:A:{tp}\n")


@pytest.fixture(scope="module")
def pafs(tmp_path_factory):
    rng = np.random.default_rng(21)
    truth, test = [], []
    for i in range(80):
        rid = f"read{i:03d}"
        tid, strand = f"ctg{int(rng.integers(3))}", "+-"[int(rng.integers(2))]
        st = int(rng.integers(0, 25_000))
        truth.append(_paf(rid, strand, tid, st, st + 400, 60, "P"))
        if i % 7 == 0:  # a secondary truth mapping elsewhere
            truth.append(_paf(rid, "+-"[i % 2], f"ctg{(i // 7) % 3}", 1_000, 1_400, 0, "S"))
        if i % 11 == 3:
            continue  # unmapped in the test set
        kind = i % 6
        if kind == 0:
            strand = "-" if strand == "+" else "+"
        elif kind == 1:
            tid = "ctg9"
        d = int(rng.choice([0, 37, 99, 100, 101, 250, -99, -100, -101]))
        test.append(_paf(rid, strand, tid, st + d, st + 400 + d, int(rng.integers(0, 61)),
                         "S" if i % 5 == 0 else "P"))
    for i in range(5):
        test.append(_paf(f"extra{i}", "+", "ctg0", 10, 410, 30, "P"))
    d = tmp_path_factory.mktemp("torch_eval")
    tp, sp = d / "truth.paf", d / "test.paf"
    tp.write_text("".join(truth))
    sp.write_text("".join(test) + "\n")  # a blank line is skipped
    return str(tp), str(sp)


@pytest.mark.parametrize("sec,tid_only", COMBOS)
def test_eval_library_matches_jax(pafs, sec, tid_only, capsys):
    from sigfish_tpu.eval import eval_main as jax_eval
    from sigfish_tpu_torch.eval import eval_main

    outs, errs, stats = [], [], []
    for fn in (eval_main, jax_eval):
        buf = io.StringIO()
        stats.append(fn(*pafs, sec=sec == "yes", tid_only=tid_only, out=buf))
        outs.append(buf.getvalue())
        errs.append(capsys.readouterr().err)
    assert outs[0] == outs[1] and errs[0] == errs[1]
    assert vars(stats[0]) == vars(stats[1])
    assert "only_in_testset\t5\n" in outs[0]
    assert 0 < stats[0].correct < stats[0].test_mapped


def _cli(module, args):
    env = dict(os.environ, SIGFISH_TPU_NO_XLA_CACHE="1", JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, "eval", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("sec,tid_only", COMBOS)
def test_eval_cli_matches_jax(pafs, sec, tid_only, tmp_path):
    """stdout and stderr of `eval`, and its -o file, are the JAX CLI's."""
    args = [*pafs, "--secondary", sec] + (["--tid-only"] if tid_only else [])
    ours = _cli("sigfish_tpu_torch.cli", args)
    theirs = _cli("sigfish_tpu.cli", args)
    assert ours.returncode == theirs.returncode == 0, ours.stderr + theirs.stderr
    assert ours.stdout == theirs.stdout and ours.stderr == theirs.stderr
    assert ours.stdout.startswith("\nComparison between truthset and testset\n")
    out = tmp_path / "eval.txt"
    assert _cli("sigfish_tpu_torch.cli", [*args, "-o", str(out)]).returncode == 0
    assert out.read_text() == ours.stdout


def test_eval_cli_refuses_a_bad_mapq_as_jax(pafs, tmp_path):
    bad = tmp_path / "bad.paf"
    bad.write_text(_paf("read001", "+", "ctg0", 0, 400, 61, "P"))
    ours = _cli("sigfish_tpu_torch.cli", [pafs[0], str(bad)])
    theirs = _cli("sigfish_tpu.cli", [pafs[0], str(bad)])
    assert ours.returncode == theirs.returncode == 1
    assert ours.stderr == theirs.stderr and "mapq 61 out of [0,60]" in ours.stderr
