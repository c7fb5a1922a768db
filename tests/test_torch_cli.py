"""The port's CLI against the reference's `dtw` option table: every flag
of sigfish_tpu/cli.py parses and is served; the multi-host flags'
validation errors are sigfish_tpu's, text and exit code, and --engine and
--accel choose the sDTW engine with sigfish_tpu's precedence (--engine by
name; --accel yes pallas, no scan; neither the wavefront kernel). The
`eval` command runs (tests/test_torch_eval.py holds its bytes to the JAX
CLI's).
"""

from __future__ import annotations

import pytest

from sigfish_tpu import cli as jax_cli
from sigfish_tpu.cli import make_dtw_parser as jax_parser
from sigfish_tpu_torch import cli


@pytest.fixture(scope="module")
def dna(tmp_path_factory):
    """chip_smoke's R9 DNA generator, 800 bases and 12 reads (one
    clipped)."""
    from port_runs import load_smoke

    return load_smoke().make_workload(str(tmp_path_factory.mktemp("cli_dna")), 800, 12, 21)[:2]


@pytest.mark.parametrize("argv,engine", [
    ([], "pallas"),
    (["--engine", "pallas"], "pallas"),
    (["--engine", "scan"], "scan"),
    (["--engine", "native"], "native"),
    (["--accel", "yes"], "pallas"),
    (["--accel", "no"], "scan"),
    (["--accel", "no", "--engine", "native"], "native"),
    (["--accel", "yes", "--engine", "scan"], "scan"),
])
def test_engine_flags_choose_the_engine(dna, argv, engine, tmp_path, monkeypatch):
    """Each --engine / --accel line runs, exit code 0, and writes the PAF
    of the port's run_dtw on the engine sigfish_tpu's precedence picks
    (the Core the CLI built reports it); the exact engines' PAF is
    sigfish_tpu's CLI output with the same flags."""
    from port_runs import run_port
    from sigfish_tpu_torch.runtime import pipeline

    built = []
    monkeypatch.setattr(pipeline.Core, "close",
                        lambda self, _close=pipeline.Core.close: (built.append(self), _close(self)))
    ours, theirs = tmp_path / "ours.paf", tmp_path / "theirs.paf"
    flags = ["-K", "8", "-t", "2", *argv]
    assert cli.main(["dtw", *dna, "--device", "cpu", *flags, "-o", str(ours)]) == 0
    assert [c.engine for c in built] == [engine]
    assert ours.read_text() == run_port(*dna, engine=engine, batch_size=8)[0] != ""
    if engine != "scan":
        jax_flags = ["-K", "8", "-t", "2", *(argv or ["--engine", "pallas"])]
        assert jax_cli.main(["dtw", *dna, *jax_flags, "-o", str(theirs)]) == 0
        assert ours.read_text() == theirs.read_text()


def test_unknown_engine_is_refused(tmp_path, capsys):
    """An engine outside pallas|scan|native is argparse's exit code 2, as
    in sigfish_tpu, before any file is opened."""
    with pytest.raises(SystemExit) as e:
        cli.main(["dtw", str(tmp_path / "ref.fa"), str(tmp_path / "reads.blow5"),
                  "--device", "cpu", "--engine", "xla"])
    assert e.value.code == 2 and "invalid choice" in capsys.readouterr().err


def _error_line(err: str) -> str:
    """argparse's last line, `PROG: error: TEXT`, without PROG."""
    return err.strip().splitlines()[-1].split(": error: ", 1)[1]


@pytest.mark.parametrize("argv", [
    ["--shard", "2/2"],
    ["--shard", "0/2", "--hosts", "2"],
    ["--hosts", "2"],
    ["--host-id", "2", "--hosts", "2"],
    ["--host-id", "-1", "--hosts", "3", "--coordinator", "localhost:1"],
])
def test_multi_host_errors_are_the_reference_s(argv, capsys, tmp_path, monkeypatch):
    """Each invalid --shard/--hosts/--host-id/--coordinator combination
    is argparse's exit code 2 with sigfish_tpu's text, before any file
    is opened (the FASTA and the BLOW5 do not exist)."""
    for var in ("SIGFISH_HOSTS", "SIGFISH_HOST_ID", "SIGFISH_COORDINATOR"):
        monkeypatch.delenv(var, raising=False)
    files = [str(tmp_path / "ref.fa"), str(tmp_path / "reads.blow5")]
    with pytest.raises(SystemExit) as theirs:
        jax_cli.dtw_main([*files, *argv])
    want = capsys.readouterr().err
    with pytest.raises(SystemExit) as ours:
        cli.main(["dtw", *files, "--device", "cpu", *argv])
    got = capsys.readouterr().err
    assert ours.value.code == theirs.value.code == 2
    assert _error_line(got) == _error_line(want), got


def test_trace_over_a_missing_fasta_is_the_reference_s_error(capsys, tmp_path, monkeypatch):
    """--trace wraps the run only: a missing FASTA is still the
    reference's one-line file error, exit code 1, and no trace is
    written."""
    from port_runs import load_smoke

    monkeypatch.setenv("SIGFISH_TPU_NO_XLA_CACHE", "1")
    _, bl, _ = load_smoke().make_workload(str(tmp_path), 600, 2, 3)
    argv = ["dtw", str(tmp_path / "missing.fa"), bl, "--trace", str(tmp_path / "t")]
    assert jax_cli.main(argv) == 1
    want = capsys.readouterr().err
    assert cli.main([*argv, "--device", "cpu"]) == 1
    got = capsys.readouterr().err
    line = [ln for ln in got.splitlines() if "ERROR" in ln]
    assert line == [ln for ln in want.splitlines() if "ERROR" in ln] and len(line) == 1, got
    assert "No such file or directory" in line[0]
    assert not (tmp_path / "t" / cli.trace_path("", 0)).exists()


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
