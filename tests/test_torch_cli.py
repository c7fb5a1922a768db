"""The port's CLI against the reference's `dtw` option table: every flag
of sigfish_tpu/cli.py parses, and the flags of later slices end with
exit code 1 and an error naming the ROADMAP.md item that brings them
(never argparse's usage line and exit code 2). The `eval` command runs
(tests/test_torch_eval.py holds its bytes to the JAX CLI's).
"""

from __future__ import annotations

import pytest

from sigfish_tpu.cli import make_dtw_parser as jax_parser
from sigfish_tpu_torch import cli


@pytest.mark.parametrize("argv,names", [
    (["--shard", "0/2"], "item 12"),
    (["--hosts", "2"], "item 12"),
    (["--host-id", "1"], "item 12"),
    (["--coordinator", "localhost:1234"], "item 12"),
    (["--trace", "d"], "item 6"),
    (["--engine", "pallas"], "--device"),
    (["--accel", "yes"], "--device"),
])
def test_later_dtw_flags_name_their_item(argv, names, capsys, tmp_path):
    rc = cli.main(["dtw", str(tmp_path / "ref.fa"), str(tmp_path / "reads.blow5"),
                   "--device", "cpu", *argv])
    err = capsys.readouterr().err
    assert rc == 1, err
    assert names in err and "usage:" not in err


def test_eval_names_its_item(capsys, tmp_path):
    """`eval` names no ROADMAP item since it is served: it runs, and a
    missing file is the reference's one-line error, exit code 1."""
    paf = tmp_path / "a.paf"
    paf.write_text("r1\t100\t0\t90\t+\tc1\t1000\t10\t300\t90\t90\t60\ttp:A:P\n")
    assert cli.main(["eval", str(paf), str(paf)]) == 0
    out = capsys.readouterr()
    assert "correct\t1 (100.00%)" in out.out and "item" not in out.err
    assert cli.main(["eval", str(paf), str(tmp_path / "missing.paf")]) == 1
    err = capsys.readouterr().err
    assert "No such file or directory" in err and "Unknown command" not in err


def test_parser_takes_every_reference_dtw_flag():
    """Each option of the reference's dtw parser exists in the port's,
    with the same default."""
    theirs = {a.dest: a.default for a in jax_parser()._actions if a.option_strings}
    ours = {a.dest: a.default for a in cli.make_dtw_parser()._actions if a.option_strings}
    assert set(theirs) <= set(ours), set(theirs) - set(ours)
    for dest, default in theirs.items():
        if dest not in ("help", "version"):
            assert ours[dest] == default, dest
